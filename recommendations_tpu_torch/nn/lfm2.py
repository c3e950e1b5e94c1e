"""LFM2-8B-A1B's hybrid block (``lfm2_moe``) as a backbone for the query tower.

Each layer is ``h = x + mixer(RMSNorm(x))``, then ``h + ffn(RMSNorm(h))``,
and a last RMSNorm (``embedding_norm``) follows the stack, as in
``transformers``' ``Lfm2DecoderLayer`` and ``Lfm2Model``:

- the mixer is a gated short convolution (``ShortConv``: ``in_proj`` to B,
  C and u, ``C * conv(B * u)`` with a depthwise causal kernel of
  ``conv_L_cache`` taps, ``out_proj``) or grouped-query attention
  (``GQAttention``: per-head RMSNorm on q and k, RoPE at positions 0..T-1,
  causal softmax, ``out_proj``), by ``layer_types``;
- the feed-forward is a dense SwiGLU (``SwiGLU``) in the first
  ``num_dense_layers`` layers and a routed mixture of SwiGLU experts
  (``RoutedMoE``) in the others.

Dtypes as in the LTHM stack (``models/lthm/model.py``): parameters and the
residual stream are float32, every matrix product takes its operands in
``dtype`` (bf16 on the card) and returns it rounded there; the norms, the
convolution, the gates, RoPE and the router's logits stay in float32.

The routed MoE drops no token and has no capacity factor: the router
scores every expert with a sigmoid, takes the top ``k`` of score plus
``expert_bias`` (a buffer, read for the choice only), and weighs the chosen
experts by their scores over the scores' sum (plus 1e-6), as the
published configuration has it (``norm_topk_prob`` true,
``routed_scaling_factor`` 1, the only values ``LFM2MoEConfig`` takes).
The (token, slot) rows are sorted by expert and
each expert's SwiGLU runs on its rows alone as two grouped products
(``torch._grouped_mm``: bf16 on the card, whose grouped kernel takes no
other type; any type on the CPU), then the rows go back to their tokens and are
summed in float32 under their weights and rounded once. The whole layer is
one autograd function whose backward is written out, so that its phases
carry ranges (``core/spans.py``): ``lthm/moe_route``, ``lthm/moe_experts``
and ``lthm/moe_combine`` in the forward, ``lthm/moe_experts_backward``
around the grouped products' backward inside ``lthm/moe_backward``. While a
profiler records, each MoE layer adds its experts' token counts to the
counter ``lthm/moe_tokens/<layer>`` (``spans.count``).

Remat (``enable_gradient_checkpointing``) runs each layer under
``torch.utils.checkpoint`` when a gradient is taken, under the LTHM stack's
``remat_policy`` (``nn/transformer.py``: ``dots_no_batch`` keeps the dense
products' outputs, the grouped products are run again). There is no
dropout, ring or sparse keep-set here.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from recommendations_tpu_torch.core.spans import count, span
from recommendations_tpu_torch.nn.attention import Dense
from recommendations_tpu_torch.nn.functional import cast_param
from recommendations_tpu_torch.nn.transformer import REMAT_SAVED, _remat_context

ATTENTION = "full_attention"


class RMSNorm(nn.Module):
    """``w * x * rsqrt(mean(x^2) + eps)`` over the last axis, in float32."""

    def __init__(self, features: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), self.weight.shape, self.weight, self.eps)


def rope_tables(t: int, head_dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (T, head_dim) float32, of positions 0..T-1 with the
    frequencies ``theta ** (-2i / head_dim)`` repeated over both halves."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device, dtype=torch.float32) / head_dim))
    freqs = torch.arange(t, device=device, dtype=torch.float32)[:, None] * inv[None, :]
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, heads, hd): ``x cos + rotate_half(x) sin``."""
    half = x.shape[-1] // 2
    rot = torch.cat((-x[..., half:], x[..., :half]), dim=-1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


def causal_depthwise_conv(u: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """u (B, T, C) float32, weight (C, 1, L): position t reads t-L+1..t,
    zeros before the first; ``Conv1d(groups=C, padding=L-1)[..., :T]``."""
    taps, t = weight.shape[-1], u.shape[1]
    up = F.pad(u, (0, 0, taps - 1, 0))
    out = up[:, :t] * weight[:, 0, 0]
    for i in range(1, taps):
        out = out + up[:, i:i + t] * weight[:, 0, i]
    return out


class ShortConv(nn.Module):
    """The gated short convolution: ``out_proj(C * conv(B * u))`` with B, C,
    u the thirds of ``in_proj(x)``; no biases."""

    def __init__(self, d: int, taps: int, generator: torch.Generator, dtype=None):
        super().__init__()
        self.in_proj = Dense(d, 3 * d, generator, use_bias=False, dtype=dtype)
        self.weight = nn.Parameter(
            torch.randn((d, 1, taps), generator=generator, device=generator.device) / math.sqrt(taps))
        self.out_proj = Dense(d, d, generator, use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, cos=None, sin=None) -> torch.Tensor:
        with span("lthm/short_conv"):
            b, c, u = self.in_proj(x).float().chunk(3, dim=-1)
            y = c * causal_depthwise_conv(b * u, self.weight)
            return self.out_proj(y)


class GQAttention(nn.Module):
    """Causal grouped-query attention with per-head RMSNorm on q and k and
    RoPE: ``n_head`` query heads over ``n_kv_head`` key/value heads (query
    head h reads key/value head ``h // (n_head / n_kv_head)``), scale
    1/sqrt(hd); no biases. On the card it runs ``scaled_dot_product_attention``
    with ``enable_gqa`` (PERF.md: faster than the KV heads repeated onto the
    port's multi-head flash kernel at B=64, T=1025, hd 64)."""

    def __init__(self, d: int, n_head: int, n_kv_head: int, eps: float, generator: torch.Generator, dtype=None):
        super().__init__()
        if d % n_head or n_head % n_kv_head:
            raise ValueError(f"hidden {d}, {n_head} heads and {n_kv_head} KV heads do not divide")
        self.n_head, self.n_kv_head, self.head_dim, self.dtype = n_head, n_kv_head, d // n_head, dtype
        kv = n_kv_head * self.head_dim
        self.q_proj = Dense(d, d, generator, use_bias=False, dtype=dtype)
        self.k_proj = Dense(d, kv, generator, use_bias=False, dtype=dtype)
        self.v_proj = Dense(d, kv, generator, use_bias=False, dtype=dtype)
        self.out_proj = Dense(d, d, generator, use_bias=False, dtype=dtype)
        self.q_layernorm = RMSNorm(self.head_dim, eps, generator.device)
        self.k_layernorm = RMSNorm(self.head_dim, eps, generator.device)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        with span("lthm/attention"):
            b, t, _ = x.shape
            hd = self.head_dim
            dt = self.dtype or torch.float32
            q = apply_rope(self.q_layernorm(self.q_proj(x).view(b, t, self.n_head, hd)), cos, sin)
            k = apply_rope(self.k_layernorm(self.k_proj(x).view(b, t, self.n_kv_head, hd)), cos, sin)
            v = self.v_proj(x).view(b, t, self.n_kv_head, hd)
            y = F.scaled_dot_product_attention(
                q.to(dt).transpose(1, 2), k.to(dt).transpose(1, 2), v.to(dt).transpose(1, 2),
                is_causal=True, enable_gqa=self.n_kv_head != self.n_head)
            return self.out_proj(y.transpose(1, 2).reshape(b, t, self.n_head * hd))


def swiglu(h1: torch.Tensor, h3: torch.Tensor) -> torch.Tensor:
    """silu(h1) * h3, each of the two rounded to the operands' dtype."""
    return F.silu(h1) * h3


def _swiglu_backward(h: torch.Tensor, da: torch.Tensor):
    """(a, dh) for a = ``swiglu`` of the halves of h (M, 2F) and da = dL/da
    (M, F), each op rounding to h's dtype as autograd's would: a as the
    forward computes it, dh1 = silu'(h1) (da h3), dh3 = da silu(h1)."""
    hidden = da.shape[-1]
    h1, h3 = h[:, :hidden], h[:, hidden:]
    silu = F.silu(h1)
    a = silu * h3
    dh = torch.empty_like(h)
    torch.ops.aten.silu_backward.grad_input(da * h3, h1, grad_input=dh[:, :hidden])
    torch.mul(da, silu, out=dh[:, hidden:])
    return a, dh


class SwiGLU(nn.Module):
    """The dense feed-forward: ``w2(silu(w1 x) * w3 x)``; no biases."""

    def __init__(self, d: int, hidden: int, generator: torch.Generator, dtype=None):
        super().__init__()
        self.w1 = Dense(d, hidden, generator, use_bias=False, dtype=dtype)
        self.w3 = Dense(d, hidden, generator, use_bias=False, dtype=dtype)
        self.w2 = Dense(hidden, d, generator, use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("lthm/mlp"):
            return self.w2(swiglu(self.w1(x), self.w3(x)))


class _Routing:
    """One forward's routing: the chosen experts (N, k), their weights
    (N, k) float32, the (token, slot) rows in expert order (``order``, M =
    N k), each row's place in that order (``place``, (N, k)), the groups'
    ends (E,) int32 and counts (E,) int64."""

    def __init__(self, scores: torch.Tensor, expert_bias: torch.Tensor, k: int):
        n, e = scores.shape
        self.choice = torch.topk(scores + expert_bias, k, dim=-1).indices
        w = scores.gather(1, self.choice)
        self.denom = w.sum(-1, keepdim=True) + 1e-6
        self.weights = w / self.denom
        flat = self.choice.reshape(-1)
        self.order = torch.sort(flat, stable=True).indices
        self.place = torch.empty_like(self.order).scatter_(
            0, self.order, torch.arange(flat.numel(), device=flat.device)).view(n, k)
        self.counts = torch.zeros(e, dtype=torch.int64, device=flat.device).scatter_add_(
            0, flat, torch.ones_like(flat))
        self.ends = torch.cumsum(self.counts, 0).to(torch.int32)


class _RoutedMoEFunction(torch.autograd.Function):
    """x (N, d) float32 -> (N, d) in ``dtype``; the backward written out
    (module docstring)."""

    @staticmethod
    def forward(ctx, x, gate, expert_bias, w13, w2, moe: "RoutedMoE"):
        dt = w13.dtype
        with span("lthm/moe_route"):
            scores = torch.sigmoid(F.linear(x, gate))
            r = _Routing(scores, expert_bias, moe.top_k)
            if moe.counter is not None:
                count(moe.counter, r.counts)
            xs = x.to(dt).index_select(0, r.order // moe.top_k)
        with span("lthm/moe_experts"):
            hidden = w2.shape[-1]
            h = torch._grouped_mm(xs, w13.transpose(1, 2), offs=r.ends)
            y = torch._grouped_mm(swiglu(h[:, :hidden], h[:, hidden:]), w2.transpose(1, 2), offs=r.ends)
        with span("lthm/moe_combine"):
            # each token's k rows, weighted and summed in float32
            yt = y.index_select(0, r.place.reshape(-1)).view(x.shape[0], moe.top_k, -1).float()
            out = torch.bmm(r.weights.unsqueeze(1), yt).squeeze(1)
            del yt
        ctx.save_for_backward(x, gate, scores, h, y, w13, w2)
        ctx.routing, ctx.moe = r, moe
        return out.to(dt)

    @staticmethod
    def backward(ctx, dout):
        x, gate, scores, h, y, w13, w2 = ctx.saved_tensors
        r, k = ctx.routing, ctx.moe.top_k
        dt = w13.dtype
        with span("lthm/moe_backward"):
            n = x.shape[0]
            dout = dout.float()
            yt = y.index_select(0, r.place.reshape(-1)).view(n, k, -1).float()
            dweights = torch.bmm(yt, dout.unsqueeze(-1)).squeeze(-1)
            del yt
            # row i of the expert order is the (token, slot) row order[i]
            dy = (r.weights.unsqueeze(-1) * dout.unsqueeze(1)).to(dt).view(n * k, -1).index_select(0, r.order)
            with span("lthm/moe_experts_backward"):
                a, dh = _swiglu_backward(h, torch._grouped_mm(dy, w2, offs=r.ends))
                dw2 = torch._grouped_mm(dy.t(), a, offs=r.ends)
                del a
                xs = x.to(dt).index_select(0, r.order // k)
                dxs = torch._grouped_mm(dh, w13, offs=r.ends)
                dw13 = torch._grouped_mm(dh.t(), xs, offs=r.ends)
                del dh, xs
            dx = dxs.index_select(0, r.place.reshape(-1)).view(n, k, -1).float().sum(1)
            del dxs
            # the router: weights = s_c / (sum s_c + 1e-6) of the chosen scores s_c
            sc = scores.gather(1, r.choice)
            dw = (dweights - (dweights * sc).sum(-1, keepdim=True) / r.denom) / r.denom
            dscores = torch.zeros_like(scores).scatter_(1, r.choice, dw)
            dlogits = dscores * scores * (1.0 - scores)
            dx += dlogits @ gate
            dgate = dlogits.t() @ x
        return dx, dgate, None, dw13, dw2, None


class RoutedMoE(nn.Module):
    """Routed SwiGLU experts, top-k of E under a sigmoid router (module
    docstring). Parameters: ``gate`` (E, d) float32; ``w13`` (E, 2F, d),
    each expert's ``w1`` over its ``w3``; ``w2`` (E, d, F); the buffer
    ``expert_bias`` (E,). ``counter``: the name the experts' token counts
    go under while a profiler records (None: not counted)."""

    def __init__(
        self, d: int, hidden: int, num_experts: int, top_k: int, generator: torch.Generator, dtype=None,
        counter: Optional[str] = None,
    ):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top {top_k} of {num_experts} experts")
        dev = generator.device
        self.top_k, self.dtype, self.counter = top_k, dtype, counter
        self.gate = nn.Parameter(torch.randn((num_experts, d), generator=generator, device=dev) / math.sqrt(d))
        self.w13 = nn.Parameter(
            torch.randn((num_experts, 2 * hidden, d), generator=generator, device=dev) / math.sqrt(d))
        self.w2 = nn.Parameter(
            torch.randn((num_experts, d, hidden), generator=generator, device=dev) / math.sqrt(hidden))
        self.register_buffer("expert_bias", torch.zeros(num_experts, device=dev))

    def route(self, x: torch.Tensor) -> torch.Tensor:
        """The chosen experts (N, k) of the rows of x (N, d), as the forward
        chooses them."""
        scores = torch.sigmoid(F.linear(x.float(), self.gate))
        return _Routing(scores, self.expert_bias, self.top_k).choice

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.float32
        flat = x.reshape(-1, x.shape[-1]).float()
        out = _RoutedMoEFunction.apply(
            flat, self.gate, self.expert_bias, cast_param(self.w13, dt), cast_param(self.w2, dt), self)
        return out.view(*x.shape[:-1], -1)


class LFM2Block(nn.Module):
    """One layer: ``operator_norm``, the mixer (``conv`` or ``self_attn``),
    ``ffn_norm``, the feed-forward (``feed_forward``, dense or routed)."""

    def __init__(self, cfg, layer: int, generator: torch.Generator, dtype=None):
        super().__init__()
        d, dev, eps = cfg.hidden_size, generator.device, cfg.norm_eps
        self.operator_norm = RMSNorm(d, eps, dev)
        self.is_attention = cfg.layer_types[layer] == ATTENTION
        if self.is_attention:
            self.self_attn = GQAttention(d, cfg.num_attention_heads, cfg.num_key_value_heads, eps, generator, dtype)
        else:
            self.conv = ShortConv(d, cfg.conv_L_cache, generator, dtype)
        self.ffn_norm = RMSNorm(d, eps, dev)
        if layer < cfg.num_dense_layers:
            self.feed_forward = SwiGLU(d, cfg.intermediate_size, generator, dtype)
        else:
            self.feed_forward = RoutedMoE(
                d, cfg.moe_intermediate_size, cfg.num_experts, cfg.num_experts_per_tok, generator, dtype,
                counter=f"lthm/moe_tokens/block_{layer}")

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        mixer = self.self_attn if self.is_attention else self.conv
        h = x + mixer(self.operator_norm(x), cos, sin)
        return h + self.feed_forward(self.ffn_norm(h))


class LFM2Stack(nn.Module):
    """The hybrid stack: ``block_{i}`` for each of ``cfg.layer_types``, then
    ``embedding_norm``; x (B, T, d) float32 in and out. ``cfg`` is an
    ``LFM2MoEConfig`` (``models/lthm/config.py``)."""

    ring_group = None  # no sequence parallelism

    def __init__(self, cfg, generator: torch.Generator, dtype=None):
        super().__init__()
        if cfg.remat_policy not in REMAT_SAVED:
            raise ValueError(f"remat_policy {cfg.remat_policy!r} not in {sorted(REMAT_SAVED)}")
        self.cfg = cfg
        self.num_layers = len(cfg.layer_types)
        for i in range(self.num_layers):
            self.add_module(f"block_{i}", LFM2Block(cfg, i, generator, dtype))
        self.embedding_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, generator.device)

    def forward(self, x: torch.Tensor, attn_mask=None, training: bool = False, dropout_seed=None,
                batch_shard=None) -> torch.Tensor:
        """``training``, ``dropout_seed`` and ``batch_shard`` are the LTHM
        stack's arguments; with no dropout here they change nothing."""
        if attn_mask is not None:
            raise ValueError("the LFM2 stack is causal and takes no additive mask")
        cfg = self.cfg
        cos, sin = rope_tables(x.shape[1], cfg.hidden_size // cfg.num_attention_heads, cfg.rope_theta, x.device)
        remat = cfg.enable_gradient_checkpointing and torch.is_grad_enabled()
        context_fn = functools.partial(_remat_context, REMAT_SAVED[cfg.remat_policy])
        for i in range(self.num_layers):
            block = getattr(self, f"block_{i}")
            if remat:
                # the blocks draw nothing from the default generators: no RNG
                # state to stash, which a captured step could not read
                x = checkpoint(block, x, cos, sin, use_reentrant=False, preserve_rng_state=False,
                               context_fn=context_fn)
            else:
                x = block(x, cos, sin)
        return self.embedding_norm(x)
