"""Attention layers: multi-query and multi-head, with relative position bias.

Port of ``recommendations_tpu/nn/attention.py``. Dispatch follows the JAX
package: without an additive mask or position bias, and at a length the
fused path serves, attention runs the flash kernel
(``ops/fused_attention``); with the position bias, a window that covers the
sequence and a length in ``BIAS_MIN_SEQ <= T <= RECOMMENDED_MAX_SEQ``, it
runs the flash kernel with the bias applied inside
(``fused_flash_attention_bias``, given the raw table); otherwise it runs
``_sdpa``, whose softmax is normalized after the V product. On a CUDA
tensor the bias kernels also take every T == window
(``fused_flash_bias_taken``), where they compute what ``_sdpa`` does;
a shorter sequence (a short request) takes ``_sdpa`` as in the JAX package,
since below the window the two paths read different table rows. The flash paths
are differentiable through their backward kernels (the bias path also with
respect to the table); ``_sdpa`` differentiates through autograd.

Ring attention (``use_ring``, ``parallel/ring_attention.py``) runs when the
layer is bound to a ring group of more than one rank (``bind_ring``), the
attention is causal and there is no additive mask; the position bias rides
the ring with nk = window. Bound by a sequence-parallel stack the layer
holds one block of the sequence (``local_blocks``); bound alone it takes
the whole sequence, pads it to the ring and gathers the blocks back, as
the JAX layer's ``ring_attention_padded`` does. When ``use_flash`` or
``use_ring`` was asked for but attention falls back to ``_sdpa``, the
layer logs a warning naming the reason, once per (layer name, reasons), as
the JAX package's ``_warn_fallback`` does.

In training, token dropout masks q, k and v before the kernel is launched,
on every route (``nn/dropout.py``: three (B, 1, T, 1) masks shared by the
heads), and flax-style dropout follows the output projection; both draw
from the block's generator, which a training forward with a nonzero rate
must pass.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from recommendations_tpu_torch.core.spans import span
from recommendations_tpu_torch.nn.dropout import dropout, qkv_dropout
from recommendations_tpu_torch.nn.functional import cast_param
from recommendations_tpu_torch.ops import fused_attention as fa
from recommendations_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_padded

NEG_INF = -1e9  # additive-mask value

logger = logging.getLogger(__name__)
_warned: set = set()


def _warn_once(key: str, msg: str) -> None:
    """A warning for a path that silently runs slower (once per key)."""
    if key not in _warned:
        _warned.add(key)
        logger.warning(msg)


class Dense(nn.Module):
    """``flax.linen.Dense``: float32 parameters, matmul in ``dtype`` (or in
    float32 when ``dtype`` is None). ``weight`` is (out, in)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        generator: torch.Generator,
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        dev = generator.device
        self.weight = nn.Parameter(
            torch.randn((out_features, in_features), generator=generator, device=dev)
            / math.sqrt(in_features)
        )
        self.bias = nn.Parameter(torch.zeros(out_features, device=dev)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        b = None if self.bias is None else cast_param(self.bias, dt)
        return F.linear(x.to(dt), cast_param(self.weight, dt), b)


def causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """(1, 1, S, S) additive causal mask (0 keep / NEG_INF drop), float32."""
    keep = torch.ones(seq_len, seq_len, dtype=torch.bool, device=device).tril()
    return torch.where(keep, 0.0, NEG_INF).float()[None, None]


class RelativePositionBias(nn.Module):
    """Learned (nq+nk+1, nh) table indexed by q-k+nk, added to the logits."""

    def __init__(self, nq: int, nk: int, nh: int, device=None):
        super().__init__()
        self.nq, self.nk = nq, nk
        self.bias = nn.Parameter(torch.zeros((nq + nk + 1, nh), device=device))

    def forward(self, qk: torch.Tensor) -> torch.Tensor:
        nq, nk = qk.shape[-2], qk.shape[-1]
        if nq > self.nq or nk > self.nk:
            raise ValueError(f"({nq},{nk}) exceeds bias table ({self.nq},{self.nk})")
        dev = qk.device
        pos = torch.arange(nq, device=dev)[:, None] - torch.arange(nk, device=dev)[None, :] + nk
        return qk + self.bias.t()[:, pos][None]  # (1, nh, nq, nk)


def _sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    pos_bias: Optional[RelativePositionBias],
) -> torch.Tensor:
    """Scaled dot-product attention; q (B, H, S, hd), k/v (B, Hk, S, hd) with
    Hk in {1, H}. Logits are stored in the compute dtype and the softmax runs
    in float32, normalized after the V product, as in the JAX package."""
    hd = q.shape[-1]
    scale = np.float32(1.0) / np.sqrt(np.float32(hd))
    q = (q.float() * float(scale)).to(q.dtype)
    logits = q.float() @ k.float().transpose(-1, -2)  # Hk=1 broadcasts over H
    logits = logits.to(q.dtype).float()  # stored in the compute dtype
    if pos_bias is not None:
        logits = pos_bias(logits)
    if mask is not None:
        logits = logits + mask
    # the shift carries no gradient (JAX: stop_gradient); in bf16 a gradient
    # through it would not cancel and would land on each row's argmax logit
    m = logits.amax(dim=-1, keepdim=True).detach()
    unnorm = torch.exp(logits - m)
    denom = unnorm.sum(dim=-1, keepdim=True)
    out = unnorm.to(v.dtype).float() @ v.float()
    return (out / denom).to(v.dtype)


class _AttentionBase(nn.Module):
    def __init__(
        self,
        n_embd: int,
        n_head: int,
        generator: torch.Generator,
        use_bias: bool = True,
        pos_bias_window: Optional[int] = None,
        use_flash: bool = False,
        use_ring: bool = False,
        dtype: Optional[torch.dtype] = None,
        dropout: float = 0.0,
        attn_dropout: float = 0.0,
        name: Optional[str] = None,
    ):
        super().__init__()
        self.name = name  # as the JAX module's name, in the fallback warning
        self.use_ring = use_ring
        self.ring_group, self.ring_local = None, False
        self.n_embd, self.n_head = n_embd, n_head
        self.head_dim = n_embd // n_head
        self.pos_bias_window = pos_bias_window
        self.use_flash = use_flash
        self.dtype = dtype
        self.dropout, self.attn_dropout = dropout, attn_dropout
        self.pos_bias = (
            RelativePositionBias(pos_bias_window, pos_bias_window, n_head, generator.device)
            if pos_bias_window is not None
            else None
        )

    def bind_ring(self, group, local_blocks: bool = False) -> None:
        """The ring's process group (None: one rank, no ring); with
        ``local_blocks`` the layer's input is this rank's sequence block."""
        self.ring_group, self.ring_local = group, local_blocks

    def _ring_eligible(self, mask, causal: bool) -> bool:
        return self.use_ring and self.ring_group is not None and mask is None and causal

    def _ring(self, q, k, v, kv_heads: int) -> torch.Tensor:
        """Ring attention on folded q (B,T,H*hd), k/v (B,T,kv_heads*hd),
        the position bias (if any) applied at q - k + window."""
        b, t, _ = q.shape
        hd = self.head_dim
        qh = q.reshape(b, t, self.n_head, hd).transpose(1, 2)
        kh = k.reshape(b, t, kv_heads, hd).transpose(1, 2)
        vh = v.reshape(b, t, kv_heads, hd).transpose(1, 2)
        table = None if self.pos_bias is None else self.pos_bias.bias
        nk = 0 if self.pos_bias is None else self.pos_bias_window
        fn = ring_attention if self.ring_local else ring_attention_padded
        y = fn(qh, kh, vh, self.ring_group, causal=True, bias_table=table, nk=nk)
        return y.transpose(1, 2).reshape(b, t, self.n_embd)

    def _flash_eligible(self, mask, seq_len: int) -> bool:
        if not self.use_flash or mask is not None or self.pos_bias_window is not None:
            return False
        return fa.fused_flash_recommended(seq_len)

    def _flash_bias_eligible(self, mask, seq_len: int, on_cuda: bool) -> bool:
        if not self.use_flash or mask is not None or self.pos_bias_window is None:
            return False
        return fa.fused_flash_bias_taken(seq_len, self.pos_bias_window, on_cuda)

    def _warn_fallback(self, mask, seq_len: int, causal: bool) -> None:
        """Name the reason a requested ring or flash path fell back to
        ``_sdpa``, with the JAX package's reasons (there: a silent
        fall-through hid a 5x production-step regression)."""
        reasons = []
        if mask is not None:
            reasons.append("an explicit additive mask")
        if self.use_ring:
            if not causal:
                reasons.append("non-causal attention (ring requires causal)")
            if self.ring_group is None:
                reasons.append("no mesh axis 'model' > 1")
            _warn_once(
                f"ring:{self.name}:{','.join(reasons)}",
                f"attention layer {self.name!r}: use_ring requested but falling back to XLA attention "
                f"because of {'; '.join(reasons) or 'kernel limits'}",
            )
            return
        if self.pos_bias_window is not None and seq_len > self.pos_bias_window:
            reasons.append(f"seq {seq_len} exceeds the pos-bias window {self.pos_bias_window}")
        if self.pos_bias_window is not None and not fa.fused_flash_bias_recommended(seq_len):
            reasons.append(
                f"seq {seq_len} outside the fused pos-bias kernel's winning range (measured crossover ~768)"
            )
        if not fa.fused_flash_recommended(seq_len):
            reasons.append(f"seq {seq_len} above the fused-kernel bound")
        _warn_once(
            f"flash:{self.name}:{','.join(reasons)}",
            f"attention layer {self.name!r}: use_flash requested but falling back to XLA attention "
            f"because of {'; '.join(reasons) or 'kernel limits'}",
        )

    def _fused_flash_bias(self, q, k, v, causal: bool) -> torch.Tensor:
        """Folded-layout flash attention with the raw (2w+1, H) bias table
        applied inside the kernel, nk = w (the JAX layer's ``_fused_flash_bias``)."""
        return fa.fused_flash_attention_bias(
            q.contiguous(), k.contiguous(), v.contiguous(), self.pos_bias.bias,
            self.n_head, self.pos_bias_window, causal,
        )

    def _dropout_generator(self, training: bool, generator: Optional[torch.Generator]):
        """The generator of a training forward with a nonzero rate; None
        when no mask is drawn."""
        if not training or not (self.dropout or self.attn_dropout):
            return None
        if generator is None:
            raise ValueError(
                f"attention layer {self.name!r}: a training forward with dropout (dropout="
                f"{self.dropout}, attn_dropout={self.attn_dropout}) needs the block's dropout generator"
            )
        return generator

    def _attend(self, x, q, k, v, kv_heads: int, mask, causal: bool, generator, shard=None) -> torch.Tensor:
        """q (B,T,H*hd), k/v (B,T,kv_heads*hd) -> (B,T,H*hd); token dropout
        (``generator`` not None) masks q, k and v first, on every route
        (``shard``: this rank's block of the batch's draw)."""
        q, k, v = qkv_dropout(q, k, v, self.attn_dropout if generator is not None else 0.0, generator, shard)
        b, t, _ = x.shape
        hd = self.head_dim
        if self._ring_eligible(mask, causal):
            return self._ring(q.to(x.dtype), k.to(x.dtype), v.to(x.dtype), kv_heads)
        if self._flash_eligible(mask, t):
            return fa.fused_flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), self.n_head, causal
            )
        if self._flash_bias_eligible(mask, t, x.is_cuda):
            return self._fused_flash_bias(q, k, v, causal)
        if self.use_flash or self.use_ring:
            self._warn_fallback(mask, t, causal)
        qh = q.reshape(b, t, self.n_head, hd).transpose(1, 2).to(x.dtype)
        kh = k.reshape(b, t, kv_heads, hd).transpose(1, 2).to(x.dtype)
        vh = v.reshape(b, t, kv_heads, hd).transpose(1, 2).to(x.dtype)
        if causal and mask is None:
            mask = causal_mask(t, x.device)
        y = _sdpa(qh, kh, vh, mask, self.pos_bias)
        return y.transpose(1, 2).reshape(b, t, self.n_embd)


class MultiQueryAttention(_AttentionBase):
    """H query heads sharing a single KV head."""

    def __init__(self, n_embd: int, n_head: int, generator: torch.Generator, **kw):
        super().__init__(n_embd, n_head, generator, **kw)
        bias, dt = kw.get("use_bias", True), kw.get("dtype")
        self.q_proj = Dense(n_embd, n_embd, generator, bias, dt)
        self.kv_proj = Dense(n_embd, 2 * self.head_dim, generator, bias, dt)
        self.out_proj = Dense(n_embd, n_embd, generator, bias, dt)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        causal: bool = False,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
        shard=None,
    ) -> torch.Tensor:
        with span("lthm/attention"):
            gen = self._dropout_generator(training, generator)
            q = self.q_proj(x)
            k, v = self.kv_proj(x).split(self.head_dim, dim=-1)
            y = self.out_proj(self._attend(x, q, k, v, 1, mask, causal, gen, shard))
            return y if gen is None else dropout(y, self.dropout, gen, shard)


class MultiHeadAttention(_AttentionBase):
    """Fused-QKV multi-head attention."""

    def __init__(self, n_embd: int, n_head: int, generator: torch.Generator, **kw):
        super().__init__(n_embd, n_head, generator, **kw)
        bias, dt = kw.get("use_bias", True), kw.get("dtype")
        self.c_attn = Dense(n_embd, 3 * n_embd, generator, bias, dt)
        self.c_proj = Dense(n_embd, n_embd, generator, bias, dt)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        causal: bool = False,
        training: bool = False,
        generator: Optional[torch.Generator] = None,
        shard=None,
    ) -> torch.Tensor:
        with span("lthm/attention"):
            gen = self._dropout_generator(training, generator)
            q, k, v = self.c_attn(x).split(self.n_embd, dim=-1)
            y = self.c_proj(self._attend(x, q, k, v, self.n_head, mask, causal, gen, shard))
            return y if gen is None else dropout(y, self.dropout, gen, shard)
