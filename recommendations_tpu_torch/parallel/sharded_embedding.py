"""Row-sharded embedding tables over the ``model`` mesh axis.

Port of ``recommendations_tpu/parallel/sharded_embedding.py``. Each rank of
a model group holds rows ``[i * R, (i + 1) * R)`` of the table (its
``table_shard``, R = rows per shard) and the ids of its data shard; the
lookups are the JAX package's two collective schedules:

- ``psum`` (``sharded_kshift_lookup``, ``sharded_embedding_lookup``): each
  rank sums the k rows of each id that it owns (a local gather with the
  rows of other shards masked to zero, summed in float32) and one
  all-reduce over the group completes the sum. The all-reduce's output is
  replicated, so its backward passes the cotangent through
  (``collectives.psum``) and each shard's gradient is its own rows'.
- ``alltoall`` (``alltoall_kshift_lookup``, ``alltoall_embedding_lookup``):
  the tokens are split over the group; each rank deduplicates the rows its
  chunk needs, sends the unique requests to their owners in fixed-capacity
  buckets (``resolve_capacity``) by one all-to-all, the owners gather, a
  second all-to-all returns the rows, a local take puts them back in token
  order, and one all-gather replicates the finished (tokens, d)
  activations. Requests past a bucket's capacity come back as zero rows and
  are counted; the count is summed over the model and data groups
  (``overflow``), as the JAX package's psum does.

The gathers read the table in the compute dtype and sum a row's duplicate
cotangents in it in a fixed order (``nn.embeddings._GatherRowsLowp``), as
the dense lookup does; the owned-row sums and the returned rows are float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from recommendations_tpu_torch.nn.embeddings import _GatherRowsLowp, kshift_row_indices
from recommendations_tpu_torch.nn.functional import l2_normalize
from recommendations_tpu_torch.parallel import collectives as col


def _gather(table_shard: torch.Tensor, idx: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    dtype = compute_dtype if compute_dtype is not None else table_shard.dtype
    return _GatherRowsLowp.apply(table_shard, idx, dtype)


def _owned_rows_sum(
    table_shard: torch.Tensor,
    global_idx: torch.Tensor,
    shard_id: int,
    rows_per_shard: int,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(..., k) global rows -> (..., d) float32 sum of the rows this shard
    owns (summed in the compute dtype's rounding, as the JAX package's
    ``jnp.sum`` of the cast rows)."""
    local = global_idx - shard_id * rows_per_shard
    owned = (local >= 0) & (local < rows_per_shard)
    rows = _gather(table_shard, torch.where(owned, local, 0), compute_dtype)
    rows = torch.where(owned[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return rows.float().sum(dim=-2).to(rows.dtype).float()


def _check_rows(table_shard: torch.Tensor, num_embeddings: int, n_shards: int) -> int:
    if num_embeddings != table_shard.shape[0] * n_shards:
        raise ValueError(f"table rows {num_embeddings} != {n_shards} shards x {table_shard.shape[0]}")
    return table_shard.shape[0]


def sharded_kshift_lookup(
    table_shard: torch.Tensor,
    ids: torch.Tensor,
    group,
    num_embeddings: int,
    num_shifts: int,
    normalize_output: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """KShift lookup over a row-sharded table (the psum schedule): (..., d)
    float32, the same on every rank of the group."""
    n = col.group_size(group)
    rows_per_shard = _check_rows(table_shard, num_embeddings, n)
    idx = kshift_row_indices(ids, num_embeddings, num_shifts)
    partial = _owned_rows_sum(table_shard, idx, col.group_rank(group), rows_per_shard, compute_dtype)
    total = col.psum(partial, group)
    if normalize_output:
        return l2_normalize(total)
    return total / math.sqrt(num_shifts)


def sharded_embedding_lookup(
    table_shard: torch.Tensor,
    ids: torch.Tensor,
    group,
    num_embeddings: int,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain row-sharded gather ``table[ids mod N]`` with one all-reduce."""
    n = col.group_size(group)
    rows_per_shard = _check_rows(table_shard, num_embeddings, n)
    idx = torch.remainder(ids.to(torch.int64), num_embeddings)[..., None]
    partial = _owned_rows_sum(table_shard, idx, col.group_rank(group), rows_per_shard, compute_dtype)
    return col.psum(partial, group)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_capacity(n_requests: int, n_shards: int, capacity_factor: float) -> int:
    """Static per-destination request capacity, a multiple of 128."""
    base = (n_requests + n_shards - 1) // n_shards
    return _round_up(max(int(math.ceil(base * capacity_factor)), 8), 128)


def _unique_alltoall_gather(
    table_shard: torch.Tensor,
    rows: torch.Tensor,
    group,
    rows_per_shard: int,
    capacity: int,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dedup -> all-to-all -> local gather -> all-to-all back -> local take.

    ``rows``: (N,) global row indices. Returns ((N, d) float32 rows, this
    rank's count of unique requests dropped past capacity)."""
    n_shards = col.group_size(group)
    dev = rows.device
    rows = rows.to(torch.int64)
    perm = torch.argsort(rows, stable=True)
    sorted_rows = rows[perm]
    uniq = torch.ones_like(sorted_rows, dtype=torch.bool)
    uniq[1:] = sorted_rows[1:] != sorted_rows[:-1]
    rank = torch.cumsum(uniq.to(torch.int64), 0) - 1  # unique rank of each position
    owner = sorted_rows // rows_per_shard  # non-decreasing
    counts = torch.zeros(n_shards, dtype=torch.int64, device=dev).index_add_(0, owner, uniq.to(torch.int64))
    offsets = torch.cumsum(counts, 0) - counts
    pos = rank - offsets[owner]  # slot within the owner's bucket
    in_cap = pos < capacity
    valid = uniq & in_cap
    overflow = (uniq & ~in_cap).sum()

    # send[s, p] = the p-th unique row owned by shard s (-1 pads); entries
    # past capacity aim at one spare slot that is cut off
    target = torch.where(valid, owner * capacity + pos, n_shards * capacity)
    send = torch.full((n_shards * capacity + 1,), -1, dtype=torch.int64, device=dev)
    send[target[valid]] = sorted_rows[valid]
    send = send[:-1].reshape(n_shards, capacity)

    recv = col.all_to_all_tensor(send, group)
    ok = recv >= 0
    local = torch.where(ok, recv - col.group_rank(group) * rows_per_shard, 0)
    gathered = _gather(table_shard, local.reshape(-1), compute_dtype).reshape(n_shards, capacity, -1)
    gathered = torch.where(ok[..., None], gathered, torch.zeros((), dtype=gathered.dtype, device=dev))
    back = col.all_to_all(gathered, group)

    # duplicates share the slot of their first occurrence
    flat = back.reshape(n_shards * capacity, -1)
    g_idx = torch.where(in_cap, owner * capacity + pos, 0)
    out_sorted = flat[g_idx]
    out_sorted = torch.where(in_cap[..., None], out_sorted, torch.zeros((), dtype=flat.dtype, device=dev))
    inv = torch.argsort(perm)
    return out_sorted[inv].float(), overflow


def _global_overflow(overflow: torch.Tensor, group, data_group) -> torch.Tensor:
    """A rank's overflow count summed over the model and data groups."""
    total = overflow.float().reshape(1).clone()
    col.all_reduce_(total, group)
    col.all_reduce_(total, data_group)
    return total.reshape(())


def _token_chunk(ids_flat: torch.Tensor, group) -> torch.Tensor:
    """This rank's 1/n of the (padded) token stream: each rank of the group
    requests only its chunk's rows."""
    n = col.group_size(group)
    t = ids_flat.shape[0]
    t_pad = _round_up(t, n)
    ids_flat = torch.cat([ids_flat, ids_flat.new_zeros(t_pad - t)])
    chunk = t_pad // n
    my = col.group_rank(group)
    return ids_flat[my * chunk:(my + 1) * chunk]


def alltoall_kshift_lookup(
    table_shard: torch.Tensor,
    ids: torch.Tensor,
    group,
    num_embeddings: int,
    num_shifts: int,
    normalize_output: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    capacity_factor: float = 2.0,
    data_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """KShift lookup by the unique-ID all-to-all schedule: ((..., d) float32,
    the same on every rank of the group; the global overflow count)."""
    n = col.group_size(group)
    rows_per_shard = _check_rows(table_shard, num_embeddings, n)
    shape, t = ids.shape, ids.numel()
    mine = _token_chunk(ids.reshape(-1), group)
    idx = kshift_row_indices(mine, num_embeddings, num_shifts)  # (chunk, k)
    capacity = resolve_capacity(idx.numel(), n, capacity_factor)
    rows, overflow = _unique_alltoall_gather(
        table_shard, idx.reshape(-1), group, rows_per_shard, capacity, compute_dtype
    )
    partial = rows.reshape(*idx.shape, -1).sum(dim=-2)
    partial = l2_normalize(partial) if normalize_output else partial / math.sqrt(num_shifts)
    out = col.all_gather(partial, group, dim=0)
    return out[:t].reshape(*shape, -1), _global_overflow(overflow, group, data_group)


def alltoall_embedding_lookup(
    table_shard: torch.Tensor,
    ids: torch.Tensor,
    group,
    num_embeddings: int,
    compute_dtype: Optional[torch.dtype] = None,
    capacity_factor: float = 2.0,
    data_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain row-sharded gather ``table[id mod N]`` by the all-to-all
    schedule: (rows, global overflow count)."""
    n = col.group_size(group)
    rows_per_shard = _check_rows(table_shard, num_embeddings, n)
    shape, t = ids.shape, ids.numel()
    mine = _token_chunk(ids.reshape(-1), group)
    idx = torch.remainder(mine.to(torch.int64), num_embeddings)
    capacity = resolve_capacity(idx.shape[0], n, capacity_factor)
    rows, overflow = _unique_alltoall_gather(table_shard, idx, group, rows_per_shard, capacity, compute_dtype)
    out = col.all_gather(rows, group, dim=0)
    return out[:t].reshape(*shape, -1), _global_overflow(overflow, group, data_group)


class ShardedKShiftEmbedding(nn.Module):
    """``KShiftEmbedding`` over a row-sharded table: ``embedding`` is this
    rank's (R, d) block of the (n R, d) table, the lookup one of the two
    schedules. After an ``alltoall`` lookup, ``overflow`` holds the global
    count of dropped requests (the JAX module's sown
    ``alltoall_overflow``)."""

    def __init__(
        self,
        table_shard: torch.Tensor,
        num_embeddings: int,
        mesh,
        num_shifts: int = 8,
        normalize_output: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        schedule: str = "alltoall",
        capacity_factor: float = 2.0,
        axis_name: str = "model",
        data_axis: str = "data",
    ):
        super().__init__()
        if schedule not in ("alltoall", "psum"):
            raise ValueError(f"embedding_lookup_schedule {schedule!r}: 'alltoall' or 'psum'")
        self.embedding = nn.Parameter(table_shard)
        self.num_embeddings, self.num_shifts = num_embeddings, num_shifts
        self.normalize_output, self.compute_dtype = normalize_output, compute_dtype
        self.schedule, self.capacity_factor = schedule, capacity_factor
        self.group, self.data_group = mesh.group(axis_name), mesh.group(data_axis)
        self.overflow: Optional[torch.Tensor] = None

    def forward(self, ids: torch.Tensor, tap: Optional[torch.Tensor] = None) -> torch.Tensor:
        if tap is not None:
            raise ValueError("a row-sharded table takes no taps (its optimizer is the dense rowwise_adam)")
        if self.schedule == "alltoall":
            out, self.overflow = alltoall_kshift_lookup(
                self.embedding, ids, self.group, self.num_embeddings, self.num_shifts,
                self.normalize_output, self.compute_dtype, self.capacity_factor, self.data_group,
            )
            return out
        return sharded_kshift_lookup(
            self.embedding, ids, self.group, self.num_embeddings, self.num_shifts,
            self.normalize_output, self.compute_dtype,
        )
