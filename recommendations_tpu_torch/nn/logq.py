"""Streaming logQ estimator for sampled-softmax correction.

Port of ``recommendations_tpu/nn/logq.py``. Per hash bucket, ``b[h]`` is an
EMA of the gap (in batch indices) between consecutive sightings of bucket
``h``, an estimate of 1/p(item), and ``logQ(id) = -log min_offsets b[h]``.

The state is explicit and updated functionally, as in the JAX package: the
update returns a new state and leaves its input alone.

Repeated buckets in one batch: the JAX update is a scatter in which the last
write in flattened order wins, and every id writes, a padding id writing back
the value it read. A CUDA ``scatter_`` with repeated indices keeps no such
order, so here every occurrence of a bucket writes the value of the bucket's
last occurrence: the repeated writes agree, in whatever order they land. The
last occurrences are found by a stable sort, at fixed shapes and with no
read of the device's values on the host, so the update can be captured in a
CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from recommendations_tpu_torch.core.spans import span


class LogQState(NamedTuple):
    b: torch.Tensor             # (n_offsets, num_buckets) f32, EMA of batch-index gaps
    a: torch.Tensor             # (n_offsets, num_buckets) f32, batch index of the last sighting
    hash_offsets: torch.Tensor  # (n_offsets,) int64


def init_logq_state(
    num_buckets: int, hash_offsets: Sequence[int], p_init: float = 0.01, device=None
) -> LogQState:
    n = len(hash_offsets)
    return LogQState(
        b=torch.full((n, num_buckets), 1.0 / p_init, dtype=torch.float32, device=device),
        a=torch.zeros((n, num_buckets), dtype=torch.float32, device=device),
        hash_offsets=torch.as_tensor(list(hash_offsets), dtype=torch.int64, device=device),
    )


def _buckets(state: LogQState, ids: torch.Tensor) -> torch.Tensor:
    """(n_offsets, ids.numel()) int64 bucket per offset: (id + offset) mod
    num_buckets, the sum wrapping in int64 and the mod taken as a floor mod,
    as ``jnp.mod`` does."""
    flat = ids.reshape(-1).to(torch.int64)
    return torch.remainder(flat[None, :] + state.hash_offsets[:, None], state.b.shape[1])


def _last_occurrence(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(buckets, last) of the (rows, n) ``h``, each row in sorted order:
    ``buckets[r, j]`` is a bucket of row r and ``last[r, j]`` the position in
    that row of the bucket's last occurrence, the same for every occurrence."""
    order = torch.sort(h, dim=1, stable=True).indices
    buckets = torch.gather(h, 1, order)
    n = h.shape[1]
    pos = torch.arange(n, device=h.device).expand_as(buckets)
    run_end = torch.ones_like(buckets, dtype=torch.bool)
    run_end[:, :-1] = buckets[:, 1:] != buckets[:, :-1]
    # each sorted slot's run end: the first end at or after it
    end = torch.where(run_end, pos, n).flip(1).cummin(1).values.flip(1)
    return buckets, torch.gather(order, 1, end)


def logq_update(
    state: LogQState,
    ids: torch.Tensor,
    valid: torch.Tensor,
    batch_idx,
    alpha: float = 0.05,
) -> LogQState:
    """One streaming step over the ids of this batch; ``valid`` (ids' shape)
    marks the real tokens. Returns the new state."""
    with span("lthm/logq"):
        hk, last = _last_occurrence(_buckets(state, ids))
        vk = valid.reshape(-1)[last]
        bi = torch.as_tensor(batch_idx, dtype=torch.float32, device=state.b.device)
        b_old, a_old = torch.gather(state.b, 1, hk), torch.gather(state.a, 1, hk)
        gap = bi - a_old
        b_new = state.b.clone().scatter_(1, hk, torch.where(vk, (1.0 - alpha) * b_old + alpha * gap, b_old))
        a_new = state.a.clone().scatter_(1, hk, torch.where(vk, bi, a_old))
        return LogQState(b=b_new, a=a_new, hash_offsets=state.hash_offsets)


def logq_correction(state: LogQState, ids: torch.Tensor) -> torch.Tensor:
    """logQ(id) = -log(min over offsets of b[h(id)]), shape ``ids.shape``."""
    h = _buckets(state, ids)
    vals = torch.gather(state.b, 1, h)
    return (-torch.log(vals.min(dim=0).values)).reshape(ids.shape)
