"""Fused in-batch contrastive cross-entropy: CUDA kernels and their plain
versions, joined by a ``torch.autograd.Function``.

Port of ``recommendations_tpu/ops/fused_ce.py``. Per loss chunk of N rows
(users x tokens per user) the LTHM loss scores every query against every
candidate, an (N, N) plane of logits. ``csrc/fused_ce.cu`` never stores that
plane: ``ce_row_diag`` and ``ce_fwd`` replace ``_row_diag_kernel`` and
``_ce_fwd_kernel`` (ce, rank and the backward's logsumexp per row;
``ce_row_diag`` also forms the logsumexp shift, which JAX computes beside its
kernels), ``ce_dq`` and ``ce_dc`` replace ``_ce_dq_kernel`` and
``_ce_dc_kernel`` (the two input gradients, each recomputing the plane from
the saved logsumexp). The JAX entry's ``tile``, ``chunk`` and ``interpret``
arguments set the TPU's geometry and are dropped: the CUDA kernels choose
their own tiling (128 or 64 own rows a block, the other side in stages of
128 rows).

Arithmetic, the JAX kernels': logits are f32 products of the bf16 operands
times ``inv_t``; a column is masked (-1e9) where it belongs to the row's user
and is not the row's own, or is invalid; off the diagonal ``beta * lq`` of
the column is subtracted; the logsumexp uses the analytic shift
``m = (inv_t + beta * max|lq|) + 1`` in float32, in that order (inputs are
L2-normalized); diag is an f32 row dot, -1e9 where the row's candidate is
invalid; ce = lse - diag, so an invalid row gives a huge but finite ce (a
fully masked one gives -inf, as the JAX package's do). The backward forms
g = (p - I) * dce * inv_t with p = 0 on rows whose lse <= -1e8, rounds g to
bf16, and sums dq = g.C and dc = g^T.Q in f32, each rounded to bf16 once.

The rounded case (``round_logits=True``): the same function with each
product q_i.c_j, and the row dot q_i.c_i, rounded to bf16 before the scale
by ``inv_t``, as the JAX package's unfused ``_ce_core`` stores its GEMM
output. Its kernels are the same four with that rounding compiled in
(``ROUNDED_KERNELS``: ``ce_row_diag_rounded``, ``ce_fwd_rounded``,
``ce_dq_rounded``, ``ce_dc_rounded``), each with a launch count of its own,
built from ``csrc/fused_ce_rounded.cu`` as a library of their own, so a
process builds only the case it launches. Its plain versions are the eager
CE of the CPU (``fused_ce`` unset) and keep ``_ce_core``'s arithmetic: S is
a bf16 GEMM's output (float32 accumulation, stored in bf16), and dq, dc are
bf16 GEMMs of the bf16 g, so over many steps they sum as the JAX package
does.

One difference from the TPU kernel, on purpose: rank counts the columns
j != i whose logit exceeds diag_i, as the unfused ``_ce_core`` does. The TPU
kernel compares column i too, its tile product against the separately summed
diag, and counts the positive itself where the two round apart.

A wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises. Under ``debug_numerics``
(``core/debug.py``) it checks what the kernel wrote and names the kernel at
a NaN or Inf, which no dispatch mode sees through ``ctypes``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from recommendations_tpu_torch.core.debug import check_kernel_outputs
from recommendations_tpu_torch.core.spans import span
from recommendations_tpu_torch.ops.cuda_build import CudaKernel

BIG_NEG = -1e9
LSE_GUARD = -1e8
SUPPORTED_DIMS = (16, 32, 64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
CE_ROW_DIAG = CudaKernel("fused_ce.cu", "ce_row_diag", [_P] * 6 + [_I] * 2 + [_F] * 2 + [_P])
CE_FWD = CudaKernel("fused_ce.cu", "ce_fwd", [_P] * 9 + [_I] * 3 + [_F] * 2 + [_P])
CE_DQ = CudaKernel("fused_ce.cu", "ce_dq", [_P] * 7 + [_I] * 3 + [_F] * 2 + [_P])
CE_DC = CudaKernel("fused_ce.cu", "ce_dc", [_P] * 7 + [_I] * 3 + [_F] * 2 + [_P])
KERNELS = (CE_ROW_DIAG, CE_FWD, CE_DQ, CE_DC)
# the rounded case: the same arguments, S rounded to bf16 (see above)
CE_ROW_DIAG_ROUNDED = CudaKernel("fused_ce_rounded.cu", "ce_row_diag_rounded", CE_ROW_DIAG.argtypes)
CE_FWD_ROUNDED = CudaKernel("fused_ce_rounded.cu", "ce_fwd_rounded", CE_FWD.argtypes)
CE_DQ_ROUNDED = CudaKernel("fused_ce_rounded.cu", "ce_dq_rounded", CE_DQ.argtypes)
CE_DC_ROUNDED = CudaKernel("fused_ce_rounded.cu", "ce_dc_rounded", CE_DC.argtypes)
ROUNDED_KERNELS = (CE_ROW_DIAG_ROUNDED, CE_FWD_ROUNDED, CE_DQ_ROUNDED, CE_DC_ROUNDED)


def _kernels(round_logits: bool):
    """(ce_row_diag, ce_fwd, ce_dq, ce_dc) of the case."""
    return ROUNDED_KERNELS if round_logits else KERNELS


def _check(q16: torch.Tensor, c16: torch.Tensor, v: torch.Tensor, lq: torch.Tensor) -> None:
    if q16.dim() != 2 or c16.shape != q16.shape or v.shape != q16.shape[:1] or lq.shape != v.shape:
        raise ValueError(
            f"expected q, c (N, D), v and lq (N,); got {tuple(q16.shape)}, {tuple(c16.shape)}, "
            f"{tuple(v.shape)}, {tuple(lq.shape)}"
        )
    if not (q16.device == c16.device == v.device == lq.device):
        raise ValueError("q, c, v and lq must lie on one device")
    if v.dtype != torch.bool:
        raise TypeError(f"v must be bool, got {v.dtype}")


def _check_launch(q16, c16, v, lq, s: int) -> None:
    n, d = q16.shape
    if d not in SUPPORTED_DIMS:
        raise ValueError(f"width {d} not in {SUPPORTED_DIMS}")
    if n < 1 or s < 1:
        raise ValueError(f"no rows ({n}) or no tokens per user ({s})")
    if q16.dtype != torch.bfloat16 or c16.dtype != torch.bfloat16 or lq.dtype != torch.float32:
        raise TypeError(f"q, c must be bfloat16 and lq float32; got {q16.dtype}, {c16.dtype}, {lq.dtype}")
    for name, x in (("q", q16), ("c", c16), ("v", v), ("lq", lq)):
        if not x.is_contiguous() or x.data_ptr() % (16 if x.dim() == 2 else x.element_size()):
            raise ValueError(f"{name} must be contiguous and aligned")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def logsumexp_shift(lq: torch.Tensor, inv_t: float, beta: float) -> torch.Tensor:
    """The analytic shift m = (inv_t + beta * max|lq|) + 1, a float32 scalar
    on lq's device, one rounding an operation in the JAX package's order
    (``_fwd_impl``): |logit| <= inv_t for unit rows, so exp(adj - m) <= 1.
    The max propagates NaN."""
    return lq.abs().amax().mul(beta).add(inv_t).add(1.0)


def _product(a: torch.Tensor, b: torch.Tensor, round_logits: bool) -> torch.Tensor:
    """a @ b: float32 products, or in the rounded case a bf16 GEMM (float32
    accumulation, the output stored in bf16; on a CUDA tensor with cuBLAS's
    reduced-precision reductions off for the call)."""
    if not round_logits:
        return a.float() @ b.float()
    a, b = a.bfloat16(), b.bfloat16()
    if not a.is_cuda:
        return a @ b
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return a @ b
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def _masked_plane(q16, c16, v, lq, s: int, inv_t: float, beta: float, round_logits: bool = False):
    """(logits, adj, eye) of the whole (N, N) plane, in float32."""
    n = q16.shape[0]
    raw = _product(q16, c16.t(), round_logits).float() * inv_t
    idx = torch.arange(n, device=q16.device)
    user = idx // s
    eye = idx[:, None] == idx[None, :]
    masked = ((user[:, None] == user[None, :]) & ~eye) | ~v[None, :]
    logits = torch.where(masked, BIG_NEG, raw)
    adj = torch.where(eye, logits, logits - beta * lq.float()[None, :])
    return logits, adj, eye


def row_diag_reference(q16, c16, v, inv_t: float, round_logits: bool = False) -> torch.Tensor:
    """The diagonal of ``ce_row_diag``'s plain version: the f32 row dot
    q_i.c_i (rounded to bf16 in the rounded case) times inv_t, -1e9 where
    the row's candidate is invalid."""
    dot = (q16.float() * c16.float()).sum(-1)
    if round_logits:
        dot = dot.bfloat16().float()
    return torch.where(v, dot * inv_t, BIG_NEG)


def row_diag_and_shift_reference(q16, c16, v, lq, inv_t: float, beta: float, round_logits: bool = False):
    """Plain PyTorch version of ``ce_row_diag``: (diag, m), the row diagonal
    and the logsumexp shift."""
    return row_diag_reference(q16, c16, v, inv_t, round_logits), logsumexp_shift(lq.float(), inv_t, beta)


def ce_fwd_reference(q16, c16, v, lq, diag, s: int, inv_t: float, beta: float, round_logits: bool = False):
    """Plain PyTorch version of ``ce_fwd``: (ce float32, rank int32, lse
    float32) per row, lse = ce + diag being the backward's residual."""
    logits, adj, eye = _masked_plane(q16, c16, v, lq, s, inv_t, beta, round_logits)
    m = logsumexp_shift(lq.float(), inv_t, beta)
    ce = m + torch.log(torch.exp(adj - m).sum(-1)) - diag
    rank = ((logits > diag[:, None]) & ~eye).sum(-1, dtype=torch.int32)
    return ce, rank, ce + diag


def ce_forward_reference(q16, c16, v, lq, s: int, inv_t: float, beta: float, round_logits: bool = False):
    """The plain versions of ``ce_row_diag`` and ``ce_fwd`` in turn."""
    _check(q16, c16, v, lq)
    diag = row_diag_reference(q16, c16, v, inv_t, round_logits)
    return ce_fwd_reference(q16, c16, v, lq, diag, s, inv_t, beta, round_logits)


def ce_forward(q16, c16, v, lq, s: int, inv_t: float, beta: float, round_logits: bool = False):
    """(ce, rank, lse) per row. CPU tensors take the plain version; CUDA
    tensors launch ``ce_row_diag`` and ``ce_fwd`` (or their rounded case)."""
    if q16.device.type == "cpu":
        return ce_forward_reference(q16, c16, v, lq, s, inv_t, beta, round_logits)
    _check(q16, c16, v, lq)
    if q16.device.type != "cuda":
        raise ValueError(f"no fused CE kernel for device {q16.device}")
    _check_launch(q16, c16, v, lq, s)
    n, d = q16.shape
    m = torch.empty((), dtype=torch.float32, device=q16.device)
    diag = torch.empty(n, dtype=torch.float32, device=q16.device)
    ce, lse = torch.empty_like(diag), torch.empty_like(diag)
    rank = torch.empty(n, dtype=torch.int32, device=q16.device)
    stream = _stream(q16)
    row_diag, fwd, _, _ = _kernels(round_logits)
    row_diag.launch(
        q16.data_ptr(), c16.data_ptr(), v.data_ptr(), lq.data_ptr(), diag.data_ptr(), m.data_ptr(),
        n, d, inv_t, beta, stream,
    )
    check_kernel_outputs(row_diag.name, (diag, m))
    fwd.launch(
        q16.data_ptr(), c16.data_ptr(), v.data_ptr(), lq.data_ptr(), m.data_ptr(), diag.data_ptr(),
        ce.data_ptr(), lse.data_ptr(), rank.data_ptr(), n, d, s, inv_t, beta, stream,
    )
    # a row whose every candidate is masked has ce = lse = -inf by design
    check_kernel_outputs(fwd.name, (ce, lse), allow_neg_inf=True)
    return ce, rank, lse


def _grad_plane(q16, c16, v, lq, lse, dce, s: int, inv_t: float, beta: float, round_logits: bool):
    """g = (p - I) * dce * inv_t of the whole (N, N) plane, rounded to bf16."""
    _, adj, eye = _masked_plane(q16, c16, v, lq, s, inv_t, beta, round_logits)
    a = dce.float() * inv_t
    lse = lse.float()[:, None]
    # padded and fully masked rows: exp(adj - lse) would overflow, and
    # inf * (a = 0) would make the products NaN
    p = torch.where(lse > LSE_GUARD, torch.exp(adj - lse), 0.0)
    return ((p - eye.float()) * a[:, None]).to(torch.bfloat16)


def ce_grad_reference(q16, c16, v, lq, lse, dce, s: int, inv_t: float, beta: float, wrt: str,
                      round_logits: bool = False):
    """Plain PyTorch version of ``ce_dq`` (``wrt="q"``) or ``ce_dc``
    (``wrt="c"``), in the operands' type."""
    g16 = _grad_plane(q16, c16, v, lq, lse, dce, s, inv_t, beta, round_logits)
    if wrt == "q":
        return _product(g16, c16, round_logits).to(q16.dtype)
    return _product(g16.t(), q16, round_logits).to(c16.dtype)


def ce_backward_reference(q16, c16, v, lq, lse, dce, s: int, inv_t: float, beta: float,
                          round_logits: bool = False):
    """The plain versions of ``ce_dq`` and ``ce_dc``: (dq, dc), from one
    plane g."""
    _check(q16, c16, v, lq)
    g16 = _grad_plane(q16, c16, v, lq, lse, dce, s, inv_t, beta, round_logits)
    return _product(g16, c16, round_logits).to(q16.dtype), _product(g16.t(), q16, round_logits).to(c16.dtype)


def ce_backward(q16, c16, v, lq, lse, dce, s: int, inv_t: float, beta: float, round_logits: bool = False):
    """(dq, dc). CPU tensors take the plain version; CUDA tensors launch
    ``ce_dq`` and ``ce_dc`` (or their rounded case)."""
    if q16.device.type == "cpu":
        return ce_backward_reference(q16, c16, v, lq, lse, dce, s, inv_t, beta, round_logits)
    _check(q16, c16, v, lq)
    if q16.device.type != "cuda":
        raise ValueError(f"no fused CE kernel for device {q16.device}")
    n, d = q16.shape
    lse = lse.float().contiguous()
    dce = dce.float().contiguous()
    if lse.shape != (n,) or dce.shape != (n,):
        raise ValueError(f"lse and dce must be ({n},); got {tuple(lse.shape)}, {tuple(dce.shape)}")
    _check_launch(q16, c16, v, lq, s)
    dq, dc = torch.empty_like(q16), torch.empty_like(c16)
    args = (q16.data_ptr(), c16.data_ptr(), v.data_ptr(), lq.data_ptr(), lse.data_ptr(), dce.data_ptr())
    stream = _stream(q16)
    _, _, dq_kernel, dc_kernel = _kernels(round_logits)
    dq_kernel.launch(*args, dq.data_ptr(), n, d, s, inv_t, beta, stream)
    check_kernel_outputs(dq_kernel.name, (dq,))
    dc_kernel.launch(*args, dc.data_ptr(), n, d, s, inv_t, beta, stream)
    check_kernel_outputs(dc_kernel.name, (dc,))
    return dq, dc


class FusedContrastiveCE(torch.autograd.Function):
    """(q16, c16, v, lq) -> (ce, rank), differentiable with respect to q16
    and c16; the saved residual is lse, O(N)."""

    @staticmethod
    def forward(ctx, q16, c16, v, lq, s: int, inv_t: float, beta: float, round_logits: bool = False):
        ce, rank, lse = ce_forward(q16, c16, v, lq, s, inv_t, beta, round_logits)
        ctx.save_for_backward(q16, c16, v, lq, lse)
        ctx.consts = (s, inv_t, beta, round_logits)
        ctx.mark_non_differentiable(rank)
        return ce, rank

    @staticmethod
    def backward(ctx, dce, _drank):
        with span("lthm/ce_backward"):
            q16, c16, v, lq, lse = ctx.saved_tensors
            dq, dc = ce_backward(q16, c16, v, lq, lse, dce, *ctx.consts)
            return dq, dc, None, None, None, None, None, None


def fused_contrastive_ce(
    q16: torch.Tensor, c16: torch.Tensor, v: torch.Tensor, lq: torch.Tensor,
    s: int, inv_t: float, beta: float, round_logits: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ce float32, rank int32) per row; differentiable with respect to q16
    and c16.

    q16, c16: (N, D) L2-normalized queries and candidates (bf16 on the card);
    v: (N,) bool candidate validity; lq: (N,) float32 logQ per candidate;
    s: tokens per user (the same-user block); inv_t = 1 / temperature;
    round_logits: the rounded case (each product stored in bf16 before the
    scale by inv_t)."""
    return FusedContrastiveCE.apply(q16, c16, v, lq, int(s), float(inv_t), float(beta), bool(round_logits))
