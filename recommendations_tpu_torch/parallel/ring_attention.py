"""Ring attention: context-parallel causal attention over a process group.

Port of ``recommendations_tpu/parallel/ring_attention.py``, plain torch as
the JAX module is plain jnp. The sequence is split over the ring's group:
each rank holds one block of q, k and v (global positions
``rank * t_local + arange(t_local)``), the k/v blocks go round the ring by
``ppermute`` and every rank accumulates its q block's attention with the
online-softmax recurrence in float32. The forward keeps q, k, v, the output
and the logsumexp; the backward runs the ring again, recomputing each hop's
probabilities from the logsumexp while the dK/dV accumulators travel with
their blocks (one more hop returns them to their owners), as JAX's custom
VJP does.

With a relative-position bias table (L, H), each hop adds
``table[q_pos - k_pos + nk]`` (rows clipped into the table) to its logits;
the table's gradient is this rank's local partial, summed over the ring and
data groups by the caller (the JAX module leaves it to ``shard_map``'s
transpose of the replicated table).

``ring_attention_padded`` pads T to a multiple of the ring at the end:
under causal masking no real query reads a pad key, and pad queries take a
zero cotangent.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from recommendations_tpu_torch.parallel import collectives as col

_NEG = -1e30


def _bias_idx(q_pos, k_pos, nk: int, l_table: int) -> torch.Tensor:
    return torch.clamp(q_pos[:, None] - k_pos[None, :] + nk, 0, l_table - 1)


def _scores(q, k, q_pos, k_pos, causal: bool, tab=None, nk: int = 0) -> torch.Tensor:
    """(b, h, q, k) float32 logits; k may have one head (MQA)."""
    d = q.shape[-1]
    if k.shape[1] == 1 and q.shape[1] != 1:
        s = torch.einsum("bhqd,bkd->bhqk", q, k[:, 0])
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    s = s / math.sqrt(d)
    if tab is not None:
        idx = _bias_idx(q_pos, k_pos, nk, tab.shape[0])
        s = s + tab.t()[:, idx][None]
    if causal:
        s = torch.where((k_pos[None, :] <= q_pos[:, None])[None, None], s, _NEG)
    return s


def _pv(p, v) -> torch.Tensor:
    if v.shape[1] == 1 and p.shape[1] != 1:
        return torch.einsum("bhqk,bkd->bhqd", p, v[:, 0])
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _positions(group, t_local: int, device):
    my = col.group_rank(group)
    base = torch.arange(t_local, device=device)
    return my, base, my * t_local + base


def _ring_fwd(q, k, v, group, causal: bool, tab=None, nk: int = 0):
    """(out, lse) in float32 for the local blocks."""
    n = col.group_size(group)
    my, base, q_pos = _positions(group, q.shape[2], q.device)
    q32 = q.float()
    k_s, v_s = k.float(), v.float()
    m = l = o = None
    for s in range(n):
        k_pos = ((my - s) % n) * q.shape[2] + base
        z = _scores(q32, k_s, q_pos, k_pos, causal, tab, nk)
        ms = z.amax(dim=-1)
        ps = torch.exp(z - ms[..., None])
        ls = ps.sum(dim=-1)
        os_ = _pv(ps, v_s)
        if m is None:
            m, l, o = ms, ls, os_
        else:
            m_new = torch.maximum(m, ms)
            a1, a2 = torch.exp(m - m_new), torch.exp(ms - m_new)
            l = a1 * l + a2 * ls
            o = a1[..., None] * o + a2[..., None] * os_
            m = m_new
        if s != n - 1:
            k_s, v_s = col.ppermute_tensor(k_s, group), col.ppermute_tensor(v_s, group)
    l_safe = torch.clamp_min(l, 1e-30)
    return o / l_safe[..., None], m + torch.log(l_safe)


def _ring_bwd(q, k, v, out, lse, g, group, causal: bool, tab=None, nk: int = 0):
    n = col.group_size(group)
    my, base, q_pos = _positions(group, q.shape[2], q.device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    mqa = k.shape[1] == 1 and q.shape[1] != 1
    q32, g32 = q.float(), g.float()
    tab32 = None if tab is None else tab.float()
    delta = (g32 * out).sum(dim=-1)
    dq = torch.zeros_like(q32)
    dtab = None if tab is None else torch.zeros_like(tab32)
    k_s, v_s = k.float(), v.float()
    dk_s, dv_s = torch.zeros_like(k_s), torch.zeros_like(v_s)
    for s in range(n):
        k_pos = ((my - s) % n) * q.shape[2] + base
        z = _scores(q32, k_s, q_pos, k_pos, causal, tab32, nk)
        p = torch.exp(z - lse[..., None])
        if mqa:
            dp = torch.einsum("bhqd,bkd->bhqk", g32, v_s[:, 0])
        else:
            dp = torch.einsum("bhqd,bhkd->bhqk", g32, v_s)
        ds = p * (dp - delta[..., None])
        if tab is not None:
            idx = _bias_idx(q_pos, k_pos, nk, tab.shape[0])
            dtab.index_add_(0, idx.reshape(-1), ds.sum(dim=0).permute(1, 2, 0).reshape(-1, tab.shape[1]))
        if mqa:
            dq += torch.einsum("bhqk,bkd->bhqd", ds, k_s[:, 0]) * scale
            dk_s = dk_s + torch.einsum("bhqk,bhqd->bkd", ds, q32)[:, None] * scale
            dv_s = dv_s + torch.einsum("bhqk,bhqd->bkd", p, g32)[:, None]
        else:
            dq += torch.einsum("bhqk,bhkd->bhqd", ds, k_s) * scale
            dk_s = dk_s + torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
            dv_s = dv_s + torch.einsum("bhqk,bhqd->bhkd", p, g32)
        # every hop rotates; the last returns the accumulators to their owner
        k_s, v_s, dk_s, dv_s = (col.ppermute_tensor(x, group) for x in (k_s, v_s, dk_s, dv_s))
    return dq, dk_s, dv_s, dtab


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, tab, group, causal: bool, nk: int):
        out, lse = _ring_fwd(q, k, v, group, causal, tab, nk)
        ctx.save_for_backward(q, k, v, tab if tab is not None else torch.empty(0), out, lse)
        ctx.group, ctx.causal, ctx.nk, ctx.has_tab = group, causal, nk, tab is not None
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, tab, out, lse = ctx.saved_tensors
        tab = tab if ctx.has_tab else None
        dq, dk, dv, dtab = _ring_bwd(q, k, v, out, lse, g, ctx.group, ctx.causal, tab, ctx.nk)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None if dtab is None else dtab.to(tab.dtype), None, None, None)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group,
    causal: bool = True,
    bias_table: Optional[torch.Tensor] = None,
    nk: int = 0,
) -> torch.Tensor:
    """Context-parallel attention on this rank's blocks: q (B, H, T/n, D),
    k and v (B, Hk, T/n, D) with Hk in {1, H}; returns q's shape and dtype.
    ``bias_table`` (L, H): the relative-position bias at q - k + nk."""
    return _RingAttention.apply(q, k, v, bias_table, group, causal, nk)


def ring_attention_padded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group,
    causal: bool = True,
    bias_table: Optional[torch.Tensor] = None,
    nk: int = 0,
) -> torch.Tensor:
    """Ring attention over the full sequence on every rank: q, k, v
    (B, H|Hk, T, D) the same on each, T padded at the end to a multiple of
    the ring, this rank's block attended, and the blocks gathered back
    (``collectives.all_gather``: the output is replicated, its backward keeps
    this rank's block). The replicated table's gradient is summed over the
    ring (``copy_to_group``), so every input's gradient is whole on every
    rank. Requires ``causal``."""
    if not causal:
        raise ValueError("padded ring attention requires causal masking")
    n = col.group_size(group)
    t = q.shape[2]
    t_pad = ((t + n - 1) // n) * n
    if t_pad != t:
        pad = (0, 0, 0, t_pad - t)
        q, k, v = (torch.nn.functional.pad(x, pad) for x in (q, k, v))
    if bias_table is not None:
        bias_table = col.copy_to_group(bias_table, group)
    blocks = [col.scatter_to_group(x, group, dim=2) for x in (q, k, v)]
    out = ring_attention(*blocks, group, causal=True, bias_table=bias_table, nk=nk)
    return col.all_gather(out, group, dim=2)[:, :, :t]
