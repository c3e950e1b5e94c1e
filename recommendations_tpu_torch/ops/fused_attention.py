"""Folded-head flash attention, forward and backward, without and with a
learned relative-position bias: CUDA kernels and their plain versions.

Port of ``recommendations_tpu/ops/fused_attention.py``. ``csrc/flash_fwd.cu``
replaces the TPU kernel ``_fwd_kernel`` and also covers the sequences the
no-bias ``_fwd_kernel_grid`` takes (T > 512): it walks K/V in 512-key chunks
with an online softmax. ``csrc/flash_bwd.cu`` replaces the backward kernels
``_fused_vjp_bwd`` launches at every length (``_bwd_fused_kernel``,
``_dq_kernel``/``_dkv_kernel`` and their grid forms). The bias variant
(``fused_flash_attention_bias``, the JAX entry of the same name) runs the
bias cases of the same kernels: ``flash_bias_fwd`` for ``_fwd_kernel_grid``
with ``bias_mode``, ``flash_bias_dq`` for ``_dq_kernel_grid`` with its
in-kernel table gradient, and ``flash_bias_dkv`` for ``_dkv_kernel_grid``;
here the dK/dV kernel sums the table gradient.

Layout as at the JAX call site: q (B, T, H*hd) with the heads folded in the
last dimension; k and v (B, T, hd) for multi-query or (B, T, H*hd) for
multi-head attention. The forward returns o (B, T, H*hd) in q's dtype and the
per-head logsumexp (B, T, H) in float32, which the backward reads.

A wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises. Under ``debug_numerics``
(``core/debug.py``) it checks what the kernel wrote and names the kernel at
a NaN or Inf, which no dispatch mode sees through ``ctypes``.

Both forwards, without and with the bias, are ``torch.library`` custom ops
with their backwards registered, so that a selective-recompute policy
(``nn/transformer.py``) can keep their outputs (o, lse) instead of running
them again, as the JAX package names them saveable (``flash_out``,
``flash_lse``). Each op also has a fake implementation (the shapes and
dtypes of o and lse), so that ``torch.export`` traces a forward that holds
it; a traced forward always goes through the op, and the exported program
launches the kernel (and counts it) each time it runs on the card.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from recommendations_tpu_torch.core.debug import check_kernel_outputs
from recommendations_tpu_torch.ops.cuda_build import CudaKernel

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# The bf16 tensor-core forward's softmax chunk: its online softmax raises the
# running max once per 16-key tile (the TPU grid kernel's chunk is 512 keys).
KERNEL_SOFTMAX_CHUNK = 16

# Dispatch knobs carried over from the JAX package (measured there on a TPU,
# not on this card): the fused path serves sequences up to this length...
RECOMMENDED_MAX_SEQ = 4096
# ...and the fused relative-position-bias kernel from this length up. On the
# CPU the dispatch is the JAX package's. On a CUDA tensor the bias kernels
# also serve every T == window: there they read the same table rows as _sdpa
# with the bias, so they compute the same function, and one layer forward +
# backward is faster fused than on _sdpa at every window from 2 to 769
# (chip_smoke.py's sweep on an H100; PERF.md). Below the window the two
# paths read different rows, and the JAX package's dispatch stays.
BIAS_MIN_SEQ = 768

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)

FLASH_FWD = CudaKernel(
    "flash_fwd.cu",
    "flash_fwd",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
)
FLASH_BWD = CudaKernel(
    "flash_bwd.cu",
    "flash_bwd",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
)
FLASH_BIAS_FWD = CudaKernel(
    "flash_fwd.cu",
    "flash_bias_fwd",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
)
FLASH_BIAS_DQ = CudaKernel(
    "flash_bwd.cu",
    "flash_bias_dq",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
)
FLASH_BIAS_DKV = CudaKernel(
    "flash_bwd.cu",
    "flash_bias_dkv",
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
)
# the number of table-gradient slices flash_bias_dkv writes (a query of its
# grid, not a kernel)
_BIAS_DKV_SLICES = CudaKernel("flash_bwd.cu", "flash_bias_dkv_slices", [ctypes.c_int] * 6)
# how much one block of the tensor-core kernels walks (queries, not kernels)
_FWD_TILES_PER_BLOCK = CudaKernel("flash_fwd.cu", "flash_fwd_tiles_per_block", [ctypes.c_int] * 5)
_DKV_ITEMS_PER_BLOCK = CudaKernel("flash_bwd.cu", "flash_dkv_items_per_block", [ctypes.c_int] * 7)
KERNELS = (FLASH_FWD, FLASH_BWD, FLASH_BIAS_FWD, FLASH_BIAS_DQ, FLASH_BIAS_DKV)


def fused_flash_recommended(seq_len: int) -> bool:
    return seq_len <= RECOMMENDED_MAX_SEQ


def fused_flash_bias_recommended(seq_len: int) -> bool:
    return BIAS_MIN_SEQ <= seq_len <= RECOMMENDED_MAX_SEQ


def fused_flash_bias_taken(seq_len: int, window: int, on_cuda: bool) -> bool:
    """Whether attention with a position bias of ``window`` takes the fused
    bias kernels at ``seq_len``: the JAX package's range within the window,
    and on a CUDA tensor also every T == window."""
    if seq_len > window:
        return False
    if fused_flash_bias_recommended(seq_len):
        return True
    return on_cuda and seq_len == window <= RECOMMENDED_MAX_SEQ


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"expected q (B,T,H*hd), k = v (B,T,C); got {q.shape}, {k.shape}, {v.shape}")
    b, t, qc = q.shape
    if qc % n_head:
        raise ValueError(f"q width {qc} is not a multiple of n_head {n_head}")
    hd = qc // n_head
    if k.shape[:2] != (b, t) or k.shape[-1] not in (hd, qc):
        raise ValueError(f"k/v {tuple(k.shape)} must be (B, T, {hd}) or (B, T, {qc})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"q/k/v must share a dtype in {SUPPORTED_DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    return b, t, qc, hd, k.shape[-1] // hd


def _softmax_exp(x: torch.Tensor, m: torch.Tensor, exp2: bool) -> torch.Tensor:
    """exp(x - m), or as the tensor-core kernels take it, 2**(x log2(e) - m log2(e))."""
    if exp2:
        return torch.exp2(x * LOG2E - m * LOG2E)
    return torch.exp(x - m)


def fused_flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, causal: bool = True,
    *, chunk: int | None = None, exp2: bool = False,
):
    """Plain PyTorch version of the kernel, with the TPU kernel's arithmetic:
    an online softmax over key chunks of ``chunk`` keys (the whole key range
    as one chunk by default; the bf16 tensor-core kernel's is
    ``KERNEL_SOFTMAX_CHUNK``): per chunk the running max rises, what earlier
    chunks summed is rescaled, p = exp(s - m) is summed in f32 and rounded to
    v's type for the PV product. ``exp2`` computes each exponential as the
    kernel does, 2**(x log2(e) - m log2(e)). Returns (o, lse)."""
    b, t, qc, hd, kvh = _check(q, k, v, n_head)
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    qh = (q.float() * scale).to(q.dtype).float().reshape(b, t, n_head, hd).transpose(1, 2)
    kh = k.float().reshape(b, t, kvh, hd).transpose(1, 2)
    s = qh @ kh.transpose(-1, -2)  # (B, H, T, T) f32; kvh=1 broadcasts over H
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril() if causal else None
    vh = v.float().reshape(b, t, kvh, hd).transpose(1, 2)
    return _online_softmax(s, keep, vh, v.dtype, chunk, exp2)


def _online_softmax(s, keep, vh, v_dtype, chunk, exp2):
    """(o, lse) from the (B, H, T, T) f32 logits s, masked where ``keep`` is
    False, and V as (B, kvh, T, hd) f32 (kvh = 1 broadcasts over H): an
    online softmax over key chunks of ``chunk`` keys (all keys as one chunk
    for None). Per chunk the running max rises, what earlier chunks summed
    is rescaled, p is summed in f32 and rounded to ``v_dtype`` for the PV
    product; o = acc / max(l, 1e-30) in ``v_dtype``, (B, T, H*hd), and lse =
    m + log(max(l, 1e-30)), (B, T, H). ``exp2`` takes each exponential as
    the tensor-core kernels do, 2**(x log2(e) - m log2(e))."""
    b, _, t, _ = s.shape
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = torch.full((*s.shape[:-1], 1), NEG_INF, device=s.device)
    den = torch.zeros_like(m)
    acc = torch.zeros((*s.shape[:-1], vh.shape[-1]), device=s.device)
    step = t if chunk is None else chunk
    for c0 in range(0, t, step):
        sc = s[..., c0 : c0 + step]
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = _softmax_exp(sc, m_new, exp2)
        if keep is not None:  # a chunk wholly past a row adds nothing to it
            p = torch.where(keep[:, c0 : c0 + step], p, 0.0)
        corr = _softmax_exp(m, m_new, exp2)
        den = den * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(v_dtype).float() @ vh[..., c0 : c0 + step, :]
        m = m_new
    den = den.clamp_min(1e-30)
    o = (acc / den).to(v_dtype).transpose(1, 2).reshape(b, t, -1)
    lse = (m + torch.log(den)).squeeze(-1).transpose(1, 2).contiguous()
    return o, lse


def kernel_softmax(q: torch.Tensor, k: torch.Tensor, n_head: int) -> dict:
    """The forward kernel's softmax arithmetic for these inputs, as keyword
    arguments of ``fused_flash_attention_reference``: the tensor-core kernel
    (bf16, MQA, 16 to 128 heads in groups of 16, hd 16, 32 or 64) takes
    16-key chunks and exp2; the FMA kernel 512-key chunks and exp. ``exp2``
    also says how the backward's kernels take p (the same inputs go to its
    tensor-core kernels, but for hd 64 with 96 heads or more, whose dK/dV
    stages do not fit, which take the FMA kernels and exp)."""
    b, t, qc, hd, kvh = _check(q, k, k, n_head)
    tensor_cores = (q.dtype == torch.bfloat16 and kvh == 1 and n_head % 16 == 0
                    and n_head <= 128 and hd in (16, 32, 64))
    return {"chunk": KERNEL_SOFTMAX_CHUNK, "exp2": True} if tensor_cores else {"chunk": 512, "exp2": False}


def _check_launch(hd: int, **tensors) -> None:
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    for name, x in tensors.items():
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def fused_flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, causal: bool = True
):
    """Flash forward: (o, lse). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    b, t, qc, hd, kvh = _check(q, k, v, n_head)
    if q.device.type == "cpu":
        return fused_flash_attention_reference(q, k, v, n_head, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    _check_launch(hd, q=q, k=k, v=v)
    o = torch.empty_like(q)
    lse = torch.empty((b, t, n_head), dtype=torch.float32, device=q.device)
    FLASH_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, n_head, kvh, hd, int(causal), int(q.dtype == torch.bfloat16), _stream(q),
    )
    check_kernel_outputs(FLASH_FWD.name, (o, lse))
    return o, lse


def _rowsum_do_o(do: torch.Tensor, o: torch.Tensor, n_head: int) -> torch.Tensor:
    """D = rowsum(dO * O) per head, (B, T, H) float32, as the JAX package
    computes it outside its kernel."""
    b, t, qc = o.shape
    return (do.float() * o.float()).reshape(b, t, n_head, qc // n_head).sum(-1)


def fused_flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, n_head: int, causal: bool = True, *, exp2: bool = False,
):
    """Plain PyTorch version of the backward kernel, spelling out
    ``_bwd_fused_kernel``'s arithmetic: qs = round(q*scale); s = qs.k in f32;
    p = exp(s - lse), masked; dp = dO.v; ds = p*(dp - D), rounded to the
    operand type; dq = ds.k*scale; dv = round(p)^T.dO; dk = ds^T.q*scale; at
    MQA dK and dV summed over heads in f32 before the one rounding. ``exp2``
    takes p as the bf16 tensor-core kernels do, 2**(s log2(e) - lse log2(e)).
    Returns (dq, dk, dv) in the operand type."""
    b, t, qc, hd, kvh = _check(q, k, v, n_head)
    dt = q.dtype
    do = do.to(dt)
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    dcol = _rowsum_do_o(do, o, n_head).transpose(1, 2)[..., None]  # (B, H, T, 1)
    heads = lambda x, nh: x.float().reshape(b, t, nh, hd).transpose(1, 2)  # noqa: E731
    qh, doh = heads(q, n_head), heads(do, n_head)
    qs = (qh * scale).to(dt).float()
    kh, vh = heads(k, kvh), heads(v, kvh)
    s = qs @ kh.transpose(-1, -2)  # (B, H, T, T); kvh=1 broadcasts over H
    p = _softmax_exp(s, lse.transpose(1, 2)[..., None], exp2)
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        p = torch.where(keep, p, 0.0)
    dp = doh @ vh.transpose(-1, -2)
    ds = (p * (dp - dcol)).to(dt).float()
    dq = (ds @ kh) * scale
    dv = p.to(dt).float().transpose(-1, -2) @ doh
    dk = (ds.transpose(-1, -2) @ qh) * scale
    if kvh == 1:
        dk, dv = dk.sum(1, keepdim=True), dv.sum(1, keepdim=True)
    fold = lambda x: x.to(dt).transpose(1, 2).reshape(b, t, -1)  # noqa: E731
    return fold(dq), fold(dk), fold(dv)


def fused_flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, n_head: int, causal: bool = True,
):
    """Flash backward: (dq, dk, dv). The cotangent is rounded to q's dtype
    first, as the JAX package does. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    b, t, qc, hd, kvh = _check(q, k, v, n_head)
    if q.device.type == "cpu":
        return fused_flash_attention_bwd_reference(q, k, v, o, lse, do, n_head, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    do = do.to(q.dtype).contiguous()
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, t, n_head):
        raise ValueError(f"o, dO must be {tuple(q.shape)} and lse {(b, t, n_head)}")
    dcol = _rowsum_do_o(do, o, n_head).contiguous()
    lse = lse.float().contiguous()
    _check_launch(hd, q=q, k=k, v=v, do=do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    FLASH_BWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dcol.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, t, n_head, kvh, hd, int(causal), int(q.dtype == torch.bfloat16), _stream(q),
    )
    check_kernel_outputs(FLASH_BWD.name, (dq, dk, dv))
    return dq, dk, dv


@torch.library.custom_op(
    "recommendations_tpu_torch::flash_attention",
    mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, int n_head, bool causal) -> (Tensor, Tensor)",
)
def flash_attention_op(q, k, v, n_head, causal):
    """(q, k, v) -> (o, lse), with the flash backward: the forward as an
    operator that a recompute policy can name (``FLASH_OP``). On the CPU both
    directions run the plain versions; on the card, the kernels."""
    return fused_flash_attention_fwd(q, k, v, n_head, causal)


def _setup_context(ctx, inputs, output):
    q, k, v, n_head, causal = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.n_head, ctx.causal = n_head, causal
    ctx.mark_non_differentiable(lse)


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = fused_flash_attention_bwd(q, k, v, o, lse, do, ctx.n_head, ctx.causal)
    return dq, dk, dv, None, None


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, n_head, causal):
    b, t, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, t, n_head), dtype=torch.float32)


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)
FLASH_OP = torch.ops.recommendations_tpu_torch.flash_attention.default


def fused_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, causal: bool = True
) -> torch.Tensor:
    """Folded-head flash attention; returns o (B, T, H*hd), differentiable
    with respect to q, k and v. Without a gradient to take (serving) the
    forward runs alone, outside the operator's autograd bookkeeping; traced
    (``torch.export``), it is the operator."""
    if torch.compiler.is_compiling() or (
        torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    ):
        return flash_attention_op(q, k, v, n_head, causal)[0]
    return fused_flash_attention_fwd(q, k, v, n_head, causal)[0]


# -- with the relative-position bias -------------------------------------------


def _check_table(table: torch.Tensor, q: torch.Tensor, t: int, n_head: int, nk: int, causal: bool):
    """The table is (L, n_head) float32 on q's device, and covers every live
    pair: T - 1 + nk < L, and without the causal mask nk >= T - 1 (the
    bounds ``RelativePositionBias`` checks, in the kernel's terms)."""
    if table.dim() != 2 or table.shape[1] != n_head or table.dtype != torch.float32:
        raise ValueError(f"bias table must be (L, {n_head}) float32; got {tuple(table.shape)} {table.dtype}")
    if table.device != q.device:
        raise ValueError("the bias table must lie on q's device")
    n_table = table.shape[0]
    if t - 1 + nk >= n_table or nk < 0 or (not causal and nk < t - 1):
        raise ValueError(f"sequence {t} with nk={nk} exceeds bias table of {n_table} rows")
    return n_table


def _bias_plane(table: torch.Tensor, t: int, nk: int) -> torch.Tensor:
    """(H, T, T) float32: table[q - k + nk, h] rounded to bf16, as the TPU
    kernel's bf16 expansion of the table (indices of masked pairs clamped)."""
    dev = table.device
    pos = torch.arange(t, device=dev)[:, None] - torch.arange(t, device=dev)[None, :] + nk
    pos = pos.clamp(0, table.shape[0] - 1)
    return table.to(torch.bfloat16).float().t()[:, pos]


def _bias_logits(q, k, table, n_head, nk, causal):
    """s = (q.k) * scale + bias in float32, (B, H, T, T), and the keep mask:
    the grid kernel's logits (q unrounded, the scale after the product)."""
    b, t, qc, hd, kvh = _check(q, k, k, n_head)
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    qh = q.float().reshape(b, t, n_head, hd).transpose(1, 2)
    kh = k.float().reshape(b, t, kvh, hd).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) * scale + _bias_plane(table, t, nk)[None]
    keep = None
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return s, keep, scale


def fused_flash_attention_bias_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor, n_head: int,
    nk: int, causal: bool = True, *, chunk: int | None = None, exp2: bool = False,
):
    """Plain PyTorch version of the bias forward, with ``_fwd_kernel_grid``'s
    arithmetic: s = (q.k) * scale + bf16(table[q - k + nk, h]) in f32,
    masked; an online softmax over key chunks of ``chunk`` keys (the whole
    key range as one chunk by default, as the grid kernel over one tile;
    the kernel's own chunk from ``bias_kernel_softmax``): p = exp(s - m), the
    PV product with p rounded to v's type; o = acc / max(l, 1e-30), lse =
    m + log(l). ``exp2`` takes each exponential as the tensor-core kernel
    does, 2**(x log2(e) - m log2(e)). Returns (o, lse)."""
    b, t, qc, hd, kvh = _check(q, k, v, n_head)
    _check_table(table, q, t, n_head, nk, causal)
    s, keep, _ = _bias_logits(q, k, table, n_head, nk, causal)
    vh = v.float().reshape(b, t, kvh, hd).transpose(1, 2)
    return _online_softmax(s, keep, vh, v.dtype, chunk, exp2)


def _mma_bias_tile(t: int, n_head: int, hd: int) -> int:
    """The staged key tile of ``mqa_mma_kernel``'s bias case, its softmax
    chunk: the largest power of two up to 512 whose K, V^T and bias stages
    fit 48 KB (``launch_mma`` in csrc/flash_fwd.cu), no longer than the
    sequence needs."""
    rows = max(1, 16 // (n_head // 16))

    def smem(tile):
        ustride = ((rows + tile - 1 + 63) & ~63) + 8
        return 2 * hd * (2 * tile + 8) + 2 * n_head * ustride

    tile = 512
    while tile > 16 and smem(tile) > 48 * 1024:
        tile >>= 1
    need = 16
    while need < t:
        need <<= 1
    return min(tile, need)


def bias_kernel_softmax(q: torch.Tensor, k: torch.Tensor, n_head: int) -> dict:
    """The bias forward kernel's softmax arithmetic for these inputs, as
    keyword arguments of ``fused_flash_attention_bias_reference``: the
    one-pass tensor-core kernel (bf16, MQA, 16 to 128 heads in groups of 16,
    hd 16, 32 or 64: the production LTHM's path) takes 16-key chunks and
    exp2; the two-pass tensor-core kernel (bf16 MQA, more groups of 16 heads,
    up to 512 heads) its staged tile and exp; the FMA kernel 512-key chunks
    and exp. ``exp2`` also names how the bias dQ kernel takes p, as the
    ``exp2`` argument of ``fused_flash_attention_bias_bwd_reference``: the
    same inputs go to ``mqa_tc_bias_dq_kernel`` (exp2) where the forward
    takes its one-pass kernel, and to ``mqa_mma_dq_kernel`` or the FMA
    kernel (exp) where it does not."""
    b, t, qc, hd, kvh = _check(q, k, k, n_head)
    mqa16 = q.dtype == torch.bfloat16 and kvh == 1 and n_head % 16 == 0 and hd in (16, 32, 64)
    if mqa16 and n_head <= 128:
        return {"chunk": KERNEL_SOFTMAX_CHUNK, "exp2": True}
    if mqa16 and n_head <= 512:
        return {"chunk": _mma_bias_tile(t, n_head, hd), "exp2": False}
    return {"chunk": 512, "exp2": False}


def fused_flash_attention_bias_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, n_head: int, nk: int, causal: bool = True, *,
    exp2: bool = False,
):
    """Plain PyTorch version of the bias backward, with the grid kernels'
    arithmetic: the cotangent rounded to q's type and D = rowsum(dO * O) in
    f32; s as the forward's; p = exp(s - lse), masked (``exp2`` takes p as
    the tensor-core dQ kernel does, 2**(s log2(e) - lse log2(e)));
    ds = p * (dp - D);
    dq = round(ds).k * scale and dk = round(ds)^T.q * scale, each scaled once
    at the end; dv = round(p)^T.dO; at MQA dK and dV summed over heads in f32
    before the one rounding. The table gradient is the unrounded f32 ds summed
    over each diagonal (straight through the bf16 rounding of the table), as
    ``_dtable_from_diag``. Returns (dq, dk, dv, dtable)."""
    b, t, qc, hd, kvh = _check(q, k, v, n_head)
    n_table = _check_table(table, q, t, n_head, nk, causal)
    dt = q.dtype
    do = do.to(dt)
    dcol = _rowsum_do_o(do, o, n_head).transpose(1, 2)[..., None]  # (B, H, T, 1)
    s, keep, scale = _bias_logits(q, k, table, n_head, nk, causal)
    p = _softmax_exp(s, lse.transpose(1, 2)[..., None], exp2)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    heads = lambda x, nh: x.float().reshape(b, t, nh, hd).transpose(1, 2)  # noqa: E731
    qh, doh, kh, vh = heads(q, n_head), heads(do, n_head), heads(k, kvh), heads(v, kvh)
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - dcol)
    dsr = ds.to(dt).float()
    dq = (dsr @ kh) * scale
    dv = p.to(dt).float().transpose(-1, -2) @ doh
    dk = (dsr.transpose(-1, -2) @ qh) * scale
    if kvh == 1:
        dk, dv = dk.sum(1, keepdim=True), dv.sum(1, keepdim=True)
    fold = lambda x: x.to(dt).transpose(1, 2).reshape(b, t, -1)  # noqa: E731
    pos = torch.arange(t, device=q.device)[:, None] - torch.arange(t, device=q.device)[None, :] + nk
    live = (pos >= 0) & (pos < n_table)
    per_pair = ds.sum(0).permute(1, 2, 0)[live]  # (pairs, H)
    dtable = torch.zeros((n_table, n_head), dtype=torch.float32, device=q.device)
    dtable.index_add_(0, pos[live], per_pair)
    return fold(dq), fold(dk), fold(dv), dtable


def fused_flash_attention_bias_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor, n_head: int,
    nk: int, causal: bool = True,
):
    """Flash forward with the position bias: (o, lse). CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    b, t, qc, hd, kvh = _check(q, k, v, n_head)
    n_table = _check_table(table, q, t, n_head, nk, causal)
    if q.device.type == "cpu":
        return fused_flash_attention_bias_reference(q, k, v, table, n_head, nk, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    _check_launch(hd, q=q, k=k, v=v, table=table)
    o = torch.empty_like(q)
    lse = torch.empty((b, t, n_head), dtype=torch.float32, device=q.device)
    FLASH_BIAS_FWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, n_head, kvh, hd, n_table, nk, int(causal), int(q.dtype == torch.bfloat16), _stream(q),
    )
    check_kernel_outputs(FLASH_BIAS_FWD.name, (o, lse))
    return o, lse


def bias_dkv_items_per_block(q: torch.Tensor, k: torch.Tensor, n_head: int) -> int:
    """The (key block, batch row) items one block of ``flash_bias_dkv``'s
    persistent grid walks at most, for CUDA tensors q and k on the current
    device; 0 where the FMA kernels take the call."""
    b, t, qc, hd, kvh = _check(q, k, k, n_head)
    return _DKV_ITEMS_PER_BLOCK.build()(b, t, n_head, kvh, hd, int(q.dtype == torch.bfloat16), 1)


def block_walk(q: torch.Tensor, k: torch.Tensor, n_head: int) -> tuple:
    """For CUDA tensors q and k on the current device: the 64-key K/V tiles
    the heaviest block of the no-bias forward (and dQ) kernel walks, and the
    (key block, batch row) items one no-bias dK/dV block walks at most; 0
    where the FMA kernels take the call."""
    b, t, qc, hd, kvh = _check(q, k, k, n_head)
    bf16 = int(q.dtype == torch.bfloat16)
    return (_FWD_TILES_PER_BLOCK.build()(t, n_head, kvh, hd, bf16),
            _DKV_ITEMS_PER_BLOCK.build()(b, t, n_head, kvh, hd, bf16, 0))


def fused_flash_attention_bias_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, n_head: int, nk: int, causal: bool = True,
):
    """Flash backward with the position bias: (dq, dk, dv, dtable). CPU
    tensors take the plain version; CUDA tensors launch the dQ kernel and the
    dK/dV kernel, which writes the table gradient in slices that no two blocks
    share; their sum (in a fixed order) is dtable."""
    b, t, qc, hd, kvh = _check(q, k, v, n_head)
    n_table = _check_table(table, q, t, n_head, nk, causal)
    if q.device.type == "cpu":
        return fused_flash_attention_bias_bwd_reference(q, k, v, table, o, lse, do, n_head, nk, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    do = do.to(q.dtype).contiguous()
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, t, n_head):
        raise ValueError(f"o, dO must be {tuple(q.shape)} and lse {(b, t, n_head)}")
    dcol = _rowsum_do_o(do, o, n_head).contiguous()
    lse = lse.float().contiguous()
    _check_launch(hd, q=q, k=k, v=v, do=do, table=table)
    bf16 = int(q.dtype == torch.bfloat16)
    slices = _BIAS_DKV_SLICES.build()(b, t, n_head, kvh, hd, bf16)
    if slices < 1:
        raise ValueError(f"flash_bias_dkv does not take head dim {hd}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = torch.zeros((slices, n_table, n_head), dtype=torch.float32, device=q.device)
    common = (b, t, n_head, kvh, hd, n_table, nk, int(causal), bf16, _stream(q))
    FLASH_BIAS_DQ.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dcol.data_ptr(),
        table.data_ptr(), dq.data_ptr(), *common,
    )
    check_kernel_outputs(FLASH_BIAS_DQ.name, (dq,))
    FLASH_BIAS_DKV.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), dcol.data_ptr(),
        table.data_ptr(), dk.data_ptr(), dv.data_ptr(), part.data_ptr(), *common,
    )
    check_kernel_outputs(FLASH_BIAS_DKV.name, (dk, dv, part))
    return dq, dk, dv, part.sum(0)


@torch.library.custom_op(
    "recommendations_tpu_torch::flash_attention_bias",
    mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor table, int n_head, int nk, bool causal) -> (Tensor, Tensor)",
)
def flash_attention_bias_op(q, k, v, table, n_head, nk, causal):
    """(q, k, v, table) -> (o, lse): the bias forward as an operator that a
    recompute policy can name (``FLASH_BIAS_OP``)."""
    return fused_flash_attention_bias_fwd(q, k, v, table, n_head, nk, causal)


def _bias_setup_context(ctx, inputs, output):
    q, k, v, table, n_head, nk, causal = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, table, o, lse)
    ctx.n_head, ctx.nk, ctx.causal = n_head, nk, causal
    ctx.mark_non_differentiable(lse)


def _bias_backward(ctx, do, _dlse):
    q, k, v, table, o, lse = ctx.saved_tensors
    dq, dk, dv, dtable = fused_flash_attention_bias_bwd(
        q, k, v, table, o, lse, do, ctx.n_head, ctx.nk, ctx.causal
    )
    return dq, dk, dv, dtable, None, None, None


@flash_attention_bias_op.register_fake
def _flash_attention_bias_fake(q, k, v, table, n_head, nk, causal):
    b, t, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, t, n_head), dtype=torch.float32)


flash_attention_bias_op.register_autograd(_bias_backward, setup_context=_bias_setup_context)
FLASH_BIAS_OP = torch.ops.recommendations_tpu_torch.flash_attention_bias.default


def fused_flash_attention_bias(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, table: torch.Tensor, n_head: int,
    nk: int, causal: bool = True,
) -> torch.Tensor:
    """Folded-head flash attention with the relative-position bias
    table[q - k + nk, h] (``table`` (L, n_head) float32, applied at bf16
    precision); returns o (B, T, H*hd), differentiable with respect to q, k,
    v and the table. Without a gradient to take (serving) the forward runs
    alone; traced (``torch.export``), it is the operator."""
    if torch.compiler.is_compiling() or (
        torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, table))
    ):
        return flash_attention_bias_op(q, k, v, table, n_head, nk, causal)[0]
    return fused_flash_attention_bias_fwd(q, k, v, table, n_head, nk, causal)[0]
