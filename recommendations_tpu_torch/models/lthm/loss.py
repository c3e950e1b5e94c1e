"""Multi-horizon in-batch contrastive loss with streaming logQ correction.

Port of ``recommendations_tpu/models/lthm/loss.py``, with both of its CEs:
``fused_ce=False`` runs ``_ce_core`` and its hand-written backward, plain
(N, N) products that the JAX package leaves to XLA outside any Pallas kernel
(``CECore`` here); ``fused_ce=True`` runs the fused CE kernels of
``ops/fused_ce.py``, which never store the (N, N) plane. The two agree on ce
up to the bf16 storage of ``_ce_core``'s logits, and on rank semantics: the
positive's own column is never counted.

One fixed (N, N) logits tile per head and mini-batch chunk, N = chunk * S:
the candidate of flattened slot (b, j) is input token (b, j + offset) and
the query is head-i output at position j, so positives sit on the diagonal;
validity, same-user and padding rules are masks and weights, and hit@k
counts rank = #(masked logits > positive).

Offsets: the JAX package draws them from ``jax.random``, whose bits a
``torch.Generator`` does not give, so ``contrastive_step`` takes them as an
argument (``offsets=``) or draws them with the same distribution from a
generator.

Over a data-parallel group (``data_group``) the loss is JAX's over the
whole batch, each rank holding its rows' part:

- the logQ update reads every rank's ids and mask (gathered), so each rank
  holds the one process's state;
- the chunks of ``train_mini_batch_size`` users are cut from the whole
  batch; each rank computes the chunks that hold its rows, on its own rows
  where a chunk lies within them, else on the group's rows gathered with
  their gradient (``collectives.all_gather``: each rank's gradient is then
  its own rows' share of the chunk's);
- the returned loss is this rank's part of the whole loss, whose gradients
  summed over the group are the one process's; the metrics (the loss
  among them) are the whole batch's, reduced over the group.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from recommendations_tpu_torch.core.debug import unchecked
from recommendations_tpu_torch.core.spans import span
from recommendations_tpu_torch.nn.functional import l2_normalize_f32acc
from recommendations_tpu_torch.nn.logq import LogQState, logq_correction, logq_update
from recommendations_tpu_torch.ops.fused_ce import fused_contrastive_ce
from recommendations_tpu_torch.parallel import collectives as col

Metrics = Dict[str, torch.Tensor]

_BIG_NEG = -1e9


def sample_offsets(generator: torch.Generator, lookahead: Sequence[int]) -> torch.Tensor:
    """offset_0 = lookahead[0]; offset_i ~ U(offset_{i-1} + 1, lookahead[i]),
    both ends included. int64 on the generator's device."""
    offsets = [int(lookahead[0])]
    for hi in lookahead[1:]:
        lo = offsets[-1] + 1
        if int(hi) < lo:  # an empty range gives its low end, as jax.random.randint
            offsets.append(lo)
            continue
        dev = generator.device
        offsets.append(int(torch.randint(lo, int(hi) + 1, (), generator=generator, device=dev)))
    return torch.tensor(offsets, dtype=torch.int64)


def _masked_adj(q, c, vv, lqv, s: int, inv_t: float, beta: float):
    """(logits, adj, eye): the masked logits, with logQ subtracted per
    candidate column off the diagonal. The GEMM output is stored in the
    operand dtype (bf16) before the f32 upcast, as in the JAX package."""
    n = q.shape[0]
    raw = torch.matmul(q, c.t()).float() * inv_t
    idx = torch.arange(n, device=q.device)
    user = idx // s
    eye = idx[:, None] == idx[None, :]
    masked = ((user[:, None] == user[None, :]) & ~eye) | ~vv[None, :]
    logits = torch.where(masked, _BIG_NEG, raw)
    adj = torch.where(eye, logits, logits - beta * lqv[None, :])
    return logits, adj, eye


def _ce_fwd_impl(q, c, vv, lqv, s, inv_t, beta):
    logits, adj, eye = _masked_adj(q, c, vv, lqv, s, inv_t, beta)
    # analytic logsumexp shift: inputs are L2-normalized, so raw logits are
    # bounded by 1/temperature and the logQ term by beta * max|logQ|
    m = inv_t + beta * lqv.abs().max() + 1.0
    lse = m + torch.log(torch.exp(adj - m).sum(-1))
    diag = adj.diagonal()
    ce = lse - diag
    rank = (logits > diag[:, None]).sum(-1, dtype=torch.int32)
    return ce, rank


class CECore(torch.autograd.Function):
    """Per-row contrastive CE and positive rank, with the JAX package's
    hand-written backward: the logits are recomputed, g = (softmax(adj) - I)
    * dce / temperature is formed once in bf16, and dq = g.C, dc = g^T.Q are
    bf16 products with f32 accumulation."""

    @staticmethod
    def forward(ctx, q, c, vv, lqv, s: int, inv_t: float, beta: float):
        ce, rank = _ce_fwd_impl(q, c, vv, lqv, s, inv_t, beta)
        ctx.save_for_backward(q, c, vv, lqv, ce)
        ctx.consts = (s, inv_t, beta)
        ctx.mark_non_differentiable(rank)
        return ce, rank

    @staticmethod
    def backward(ctx, dce, _drank):
        with span("lthm/ce_backward"):
            q, c, vv, lqv, ce = ctx.saved_tensors
            s, inv_t, beta = ctx.consts
            _, adj, eye = _masked_adj(q, c, vv, lqv, s, inv_t, beta)
            diag = adj.diagonal()
            # a fully masked row (ce = -inf) gets lse 0, so its p underflows to
            # exactly 0 instead of inf (inf * 0 would NaN the chunk's dc)
            lse = torch.where(torch.isfinite(ce), ce + diag, 0.0)
            a = dce.float() * inv_t
            p = torch.exp(adj - lse[:, None])
            g16 = ((p - eye.float()) * a[:, None]).to(torch.bfloat16)
            dq = torch.matmul(g16, c.to(torch.bfloat16)).to(q.dtype)
            dc = torch.matmul(g16.t(), q.to(torch.bfloat16)).to(c.dtype)
            return dq, dc, None, None, None, None, None


def _ce_rows(q16, c16, v, lq, s: int, temperature: float, beta: float, fused_ce: bool = False):
    """Per-row (ce, rank): the fused CE kernels, or ``CECore``'s plain
    products with bf16-stored logits."""
    if fused_ce:
        return fused_contrastive_ce(q16, c16, v, lq, s, float(1.0 / temperature), float(beta))
    return CECore.apply(q16, c16, v, lq, s, float(1.0 / temperature), float(beta))


def _head_loss(
    query: torch.Tensor,      # (Bc, S, D) normalized head-i outputs
    cand: torch.Tensor,       # (Bc, S, D) normalized rolled candidates
    valid: torch.Tensor,      # (Bc, S) slot validity
    cand_logq: torch.Tensor,  # (Bc, S) logQ of candidate tokens
    temperature: float,
    beta: float,
    fused_ce: bool = False,
) -> Tuple[torch.Tensor, Metrics]:
    bc, s, d = query.shape
    n = bc * s
    q16 = query.reshape(n, d).to(torch.bfloat16)
    c16 = cand.reshape(n, d).to(torch.bfloat16)
    v = valid.reshape(n)
    lq = cand_logq.reshape(n).float().detach()
    ce, rank = _ce_rows(q16, c16, v, lq, s, float(temperature), float(beta), fused_ce)

    # negatives per row, closed form: valid columns that are cross-user or
    # the diagonal, minus the positive
    vf = v.float()
    per_user = vf.reshape(bc, s).sum(-1)
    num_neg = (vf.sum() - per_user.repeat_interleave(s) + vf - 1.0).to(torch.int32)
    w = (v & (num_neg > 0)).float()

    # NaN filter; also catches the -inf of a fully masked row (w = 0 there)
    ce = torch.where(torch.isfinite(ce), ce, 0.0)
    used = w.sum()
    denom = used.clamp_min(1.0)
    loss = (ce * w).sum() / denom
    # the median rank of a chunk without a used token is NaN by design
    with torch.no_grad(), unchecked():
        metrics = {
            "effective_batch_size": used,
            "average_negatives_per_token": (num_neg * w).sum() / denom,
            "used_tokens": used,
            "loss_all_tokens": loss.detach(),
            "average_hit_position": (rank * w).sum() / denom,
            "median_hit_position": torch.nanquantile(
                torch.where(w > 0, rank.float(), float("nan")), 0.5
            ),
            "_rank": rank,
            "_weight": w,
            "_min_neg": torch.where(w > 0, num_neg, torch.iinfo(torch.int32).max).min(),
        }
    return loss, metrics


def contrastive_step(
    output: Dict[str, torch.Tensor],
    logq_state: LogQState,
    batch_idx: torch.Tensor,
    *,
    lookahead: List[int],
    temperature: float,
    beta: float,
    alpha: float,
    metrics_k_all: List[int],
    train_mini_batch_size: int,
    training: bool,
    fused_ce: bool = False,
    offsets=None,
    generator: Optional[torch.Generator] = None,
    data_group=None,
) -> Tuple[torch.Tensor, Metrics, LogQState]:
    """Loss over the macro batch, the metrics under the JAX package's keys,
    and the new logQ state (updated in training only).

    ``offsets`` (one int per head) overrides the draw from ``generator``.
    Chunks of ``train_mini_batch_size`` users (training only) each give an
    (N, N) tile; the loss and metrics are averaged over chunks, as the JAX
    package's scan does. ``data_group``: the ranks that hold the other rows
    of the batch (see the module docstring)."""
    out_emb = l2_normalize_f32acc(output["next_token_emb"])
    in_emb = l2_normalize_f32acc(output["current_token_emb"])
    mask = output["current_token_mask"]
    ids = output["current_token_ids"]

    b_local, s = mask.shape
    n_ranks, r = col.group_size(data_group), col.group_rank(data_group)
    b, row0 = b_local * n_ranks, r * b_local
    k_heads = len(lookahead)
    if out_emb.shape[1] != s + 1 or out_emb.shape[2] != k_heads:
        raise ValueError(f"next_token_emb {tuple(out_emb.shape)} does not fit mask {(b_local, s)}")

    if training:
        all_ids, all_mask = (col.all_gather_tensor(t, data_group) for t in (ids, mask))
        logq_state = logq_update(logq_state, all_ids, ~all_mask, batch_idx, alpha=alpha)
    logq = logq_correction(logq_state, ids)

    if offsets is None:
        if generator is None:
            raise ValueError("contrastive_step needs offsets or a generator to draw them")
        offsets = sample_offsets(generator, lookahead)
    offsets = [int(o) for o in np.asarray(offsets).reshape(-1)]
    if len(offsets) != k_heads:
        raise ValueError(f"{len(offsets)} offsets for {k_heads} heads")

    prefix = "train" if training else "val"
    chunk = train_mini_batch_size if (training and train_mini_batch_size > 0) else b
    chunk = min(chunk, b)
    bounds = [(cs, min(cs + chunk, b)) for cs in range(0, b, chunk)]
    # the chunks that hold this rank's rows; a chunk is reported by the rank
    # of its first row
    mine = [(cs, ce) for cs, ce in bounds if cs < row0 + b_local and ce > row0]
    local = all(cs // b_local == (ce - 1) // b_local for cs, ce in bounds)
    if not local:
        out_emb, in_emb, mask, logq = (
            col.all_gather(out_emb, data_group), col.all_gather(in_emb, data_group),
            col.all_gather_tensor(mask, data_group), col.all_gather_tensor(logq, data_group),
        )
    base = row0 if local else 0  # global row of the tensors' row 0

    dev = out_emb.device
    total_loss = torch.zeros((), dtype=torch.float32, device=dev)
    with span("lthm/loss_metrics"):
        metrics: Metrics = {
            f"{prefix}_batch_size": torch.tensor(float(b), device=dev),
            f"{prefix}_seq_len": torch.tensor(float(s), device=dev),
        }
    pos = torch.arange(s, device=dev)[None, :]
    heads = []
    for i, off in enumerate(offsets):
        # roll the candidate stream so slot (b, j) pairs with token (b, j+off)
        cand = torch.roll(in_emb, -off, dims=1)
        cand_mask = torch.roll(mask, -off, dims=1)
        cand_logq = torch.roll(logq, -off, dims=1)
        valid = ~cand_mask & (pos < s - off)
        query = out_emb[:, :s, i, :]

        losses, reported, ranks, weights, min_negs = [], [], [], [], []
        for cs, ce in mine:
            sl = slice(cs - base, ce - base)
            loss_c, m = _head_loss(
                query[sl], cand[sl], valid[sl], cand_logq[sl], temperature, beta, fused_ce
            )
            losses.append(loss_c)
            # this rank's rows of the chunk
            own = slice((max(cs, row0) - cs) * s, (min(ce, row0 + b_local) - cs) * s)
            ranks.append(m.pop("_rank")[own])
            weights.append(m.pop("_weight")[own])
            min_negs.append(m.pop("_min_neg"))
            if cs >= row0:
                reported.append(m)
        head_loss = torch.stack(losses).sum() / len(bounds)
        total_loss = total_loss + head_loss
        heads.append((off, reported, torch.cat(ranks), torch.cat(weights), torch.stack(min_negs).min()))

    # the whole batch's metrics: chunk means, the hit rates over every row
    with span("lthm/loss_metrics"), torch.no_grad(), unchecked():
        keys = ["effective_batch_size", "average_negatives_per_token", "used_tokens", "loss_all_tokens",
                "average_hit_position", "median_hit_position"]
        min_neg = torch.stack([h[4] for h in heads])
        col.all_reduce_(min_neg, data_group, op=torch.distributed.ReduceOp.MIN)
        sums = []
        for (off, reported, rank_all, w_all, _), mn in zip(heads, min_neg):
            chunk_sums = [torch.stack([m[key] for m in reported]).sum() if reported
                          else torch.zeros((), device=dev) for key in keys]
            hits = [((rank_all < torch.clamp(mn, max=k)).float() * w_all).sum() for k in metrics_k_all]
            sums.append(torch.stack([*chunk_sums, *hits, w_all.sum()]).float())
        sums = torch.stack(sums)
        col.all_reduce_(sums, data_group)
        for i, (off, *_), row in zip(range(k_heads), heads, sums):
            agg = {key: row[j] / len(bounds) for j, key in enumerate(keys)}
            used = row[-1].clamp_min(1.0)
            for j, k in enumerate(metrics_k_all):
                agg[f"hit_rate_at_{k}"] = row[len(keys) + j] / used
            agg["offset"] = torch.tensor(float(off), device=dev)
            for key, val in agg.items():
                metrics[f"{prefix}_{key}_lookahead_{i}"] = val
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for row in sums:  # the heads' losses added in order, as the step adds them
            loss_sum = loss_sum + row[keys.index("loss_all_tokens")] / len(bounds)
        metrics[f"{prefix}_loss"] = loss_sum
    return total_loss, metrics, logq_state
