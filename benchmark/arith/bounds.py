"""Least times of the kernels from their shapes: the bytes each call must
move over HBM rate, or its products over the peak rate for their type,
whichever is larger. Frozen copies of the bound arithmetic the port's chip
smoke test used when the benchmark was defined; the program may change, this
yardstick may not.

Peaks (``PEAKS``): one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at
the full 700 W power limit.
"""

from __future__ import annotations

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops_per_s": 989e12,
    "f32_flops_per_s": 67e12,
}


def _least(nbytes: float, flops: float, peak: float) -> float:
    """Seconds: the larger of bytes over HBM rate and flops over ``peak``."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / peak)


def _peak(bf16: bool) -> float:
    return PEAKS["bf16_flops_per_s"] if bf16 else PEAKS["f32_flops_per_s"]


def live_pairs(t: int, causal: bool) -> int:
    return t * (t + 1) // 2 if causal else t * t


def flash_bias_s(kernel: str, b: int, t: int, n_head: int, hd: int, kvh: int, n_table: int,
                 causal: bool = True, bf16: bool = True) -> float:
    """One call of a flash kernel with the relative-position bias: inputs
    read and outputs written once (the (n_table, H) float32 table read, and
    by the dK/dV kernel its gradient written), or its products over the
    live pairs: forward s and pv; dQ s, dp, dq; dK/dV s, dp, dv, dk."""
    el = 2 if bf16 else 4
    qb, kb, rb, tb = b * t * n_head * hd * el, b * t * kvh * hd * el, b * t * n_head * 4, n_table * n_head * 4
    nbytes, products = {
        "flash_bias_fwd": (2 * qb + 2 * kb + rb + tb, 2),
        "flash_bias_dq": (3 * qb + 2 * kb + 2 * rb + tb, 3),
        "flash_bias_dkv": (2 * qb + 4 * kb + 2 * rb + 2 * tb, 4),
    }[kernel]
    flops = products * 2 * hd * n_head * b * live_pairs(t, causal)
    return _least(nbytes, flops, _peak(bf16))


def ce_s(kernel: str, n: int, d: int) -> float:
    """One call of a contrastive-CE kernel at (N, D), bf16 rows: its inputs
    read and outputs written once, or its products (the row dot on the
    float32 units, the tiles' products on the tensor cores)."""
    rows = 2 * n * d * 2 + n  # q, c, v
    if kernel == "ce_row_diag":  # lq read, diag and m written
        return _least(rows + 4 * n + 4 * n + 4, 2 * n * d, PEAKS["f32_flops_per_s"])
    if kernel == "ce_fwd":
        return _least(rows + 2 * 4 * n + 4 + 3 * 4 * n, 2 * n * n * d, PEAKS["bf16_flops_per_s"])
    if kernel in ("ce_dq", "ce_dc"):  # S and the gradient product
        return _least(rows + 3 * 4 * n + n * d * 2, 4 * n * n * d, PEAKS["bf16_flops_per_s"])
    raise ValueError(f"unknown CE kernel {kernel!r}")


CE_KERNELS = ("ce_row_diag", "ce_fwd", "ce_dq", "ce_dc")
