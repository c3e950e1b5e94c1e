"""Folded-head flash attention, forward and backward: CUDA kernels and their
plain versions, joined by a ``torch.autograd.Function``.

Port of ``recommendations_tpu/ops/fused_attention.py`` without the position
bias. ``csrc/flash_fwd.cu`` replaces the TPU kernel ``_fwd_kernel`` and also
covers the sequences the no-bias ``_fwd_kernel_grid`` takes (T > 512): it
walks K/V in 512-key chunks with an online softmax. ``csrc/flash_bwd.cu``
replaces the backward kernels ``_fused_vjp_bwd`` launches at every length
(``_bwd_fused_kernel``, ``_dq_kernel``/``_dkv_kernel`` and their grid forms).

Layout as at the JAX call site: q (B, T, H*hd) with the heads folded in the
last dimension; k and v (B, T, hd) for multi-query or (B, T, H*hd) for
multi-head attention. The forward returns o (B, T, H*hd) in q's dtype and the
per-head logsumexp (B, T, H) in float32, which the backward reads.

A wrapper takes the plain version only for tensors on the CPU. For a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from recommendations_tpu_torch.ops.cuda_build import CudaKernel

NEG_INF = -1e30

# Dispatch knobs carried over from the JAX package (measured there on a TPU,
# not on this card): the fused path serves sequences up to this length...
RECOMMENDED_MAX_SEQ = 4096
# ...and the fused relative-position-bias kernel from this length up.
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


def fused_flash_recommended(seq_len: int) -> bool:
    return seq_len <= RECOMMENDED_MAX_SEQ


def fused_flash_bias_recommended(seq_len: int) -> bool:
    return BIAS_MIN_SEQ <= seq_len <= RECOMMENDED_MAX_SEQ


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


def fused_flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, causal: bool = True
):
    """Plain PyTorch version of the kernel, with the TPU kernel's arithmetic
    over the whole key range as one chunk. Returns (o, lse)."""
    b, t, qc, hd, kvh = _check(q, k, v, n_head)
    scale = float(np.float32(1.0 / math.sqrt(hd)))
    qh = (q.float() * scale).to(q.dtype).float().reshape(b, t, n_head, hd).transpose(1, 2)
    kh = k.float().reshape(b, t, kvh, hd).transpose(1, 2)
    vh = v.float().reshape(b, t, kvh, hd).transpose(1, 2)
    s = qh @ kh.transpose(-1, -2)  # (B, H, T, T) f32; kvh=1 broadcasts over H
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = p.to(v.dtype).float() @ vh
    o = (acc / den).to(q.dtype).transpose(1, 2).reshape(b, t, qc)
    lse = (m + torch.log(den)).squeeze(-1).transpose(1, 2).contiguous()
    return o, lse


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
    return o, lse


def _rowsum_do_o(do: torch.Tensor, o: torch.Tensor, n_head: int) -> torch.Tensor:
    """D = rowsum(dO * O) per head, (B, T, H) float32, as the JAX package
    computes it outside its kernel."""
    b, t, qc = o.shape
    return (do.float() * o.float()).reshape(b, t, n_head, qc // n_head).sum(-1)


def fused_flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, n_head: int, causal: bool = True,
):
    """Plain PyTorch version of the backward kernel, spelling out
    ``_bwd_fused_kernel``'s arithmetic: qs = round(q*scale); s = qs.k in f32;
    p = exp(s - lse), masked; dp = dO.v; ds = p*(dp - D), rounded to the
    operand type; dq = ds.k*scale; dv = round(p)^T.dO; dk = ds^T.q*scale; at
    MQA dK and dV summed over heads in f32 before the one rounding. Returns
    (dq, dk, dv) in the operand type."""
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
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
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
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(q, k, v) -> (o, lse), with the flash backward. On the CPU both
    directions run the plain versions; on the card, the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, n_head: int, causal: bool):
        o, lse = fused_flash_attention_fwd(q, k, v, n_head, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.n_head, ctx.causal = n_head, causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fused_flash_attention_bwd(q, k, v, o, lse, do, ctx.n_head, ctx.causal)
        return dq, dk, dv, None, None


def fused_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, causal: bool = True
) -> torch.Tensor:
    """Folded-head flash attention; returns o (B, T, H*hd), differentiable
    with respect to q, k and v. Without a gradient to take (serving) the
    forward runs alone, without the autograd Function's bookkeeping."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, n_head, causal)[0]
    return fused_flash_attention_fwd(q, k, v, n_head, causal)[0]
