"""Streaming logQ estimator for sampled-softmax correction.

Port of ``recommendations_tpu/nn/logq.py``. Per hash bucket, ``b[h]`` is an
EMA of the gap (in batch indices) between consecutive sightings of bucket
``h``, an estimate of 1/p(item), and ``logQ(id) = -log min_offsets b[h]``.

The state is explicit and updated functionally, as in the JAX package: the
update returns a new state and leaves its input alone.

Repeated buckets in one batch: the JAX update is a scatter in which the last
write in flattened order wins, and every id writes, a padding id writing back
the value it read. A CUDA ``index_put_`` with repeated indices keeps no such
order, so the update here first keeps, for each bucket, only its last
occurrence, and then writes unique indices.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


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


def _last_occurrence(h: torch.Tensor) -> torch.Tensor:
    """Positions in the 1-D ``h`` of each value's last occurrence."""
    order = torch.sort(h, stable=True).indices
    sorted_h = h[order]
    last = torch.ones_like(sorted_h, dtype=torch.bool)
    last[:-1] = sorted_h[1:] != sorted_h[:-1]
    return order[last]


def logq_update(
    state: LogQState,
    ids: torch.Tensor,
    valid: torch.Tensor,
    batch_idx,
    alpha: float = 0.05,
) -> LogQState:
    """One streaming step over the ids of this batch; ``valid`` (ids' shape)
    marks the real tokens. Returns the new state."""
    h = _buckets(state, ids)
    v = valid.reshape(-1)
    bi = torch.as_tensor(batch_idx, dtype=torch.float32, device=state.b.device)
    b_new, a_new = state.b.clone(), state.a.clone()
    for row in range(h.shape[0]):
        keep = _last_occurrence(h[row])
        hk, vk = h[row, keep], v[keep]
        b_old, a_old = state.b[row, hk], state.a[row, hk]
        gap = bi - a_old
        b_new[row, hk] = torch.where(vk, (1.0 - alpha) * b_old + alpha * gap, b_old)
        a_new[row, hk] = torch.where(vk, bi, a_old)
    return LogQState(b=b_new, a=a_new, hash_offsets=state.hash_offsets)


def logq_correction(state: LogQState, ids: torch.Tensor) -> torch.Tensor:
    """logQ(id) = -log(min over offsets of b[h(id)]), shape ``ids.shape``."""
    h = _buckets(state, ids)
    vals = torch.gather(state.b, 1, h)
    return (-torch.log(vals.min(dim=0).values)).reshape(ids.shape)
