"""Row-sparse updates of the product-embedding table.

Port of ``recommendations_tpu/train/sparse_table.py``. Both updates are
rowwise Adam (the second moment averaged per row, as
``train/optimizers.RowwiseAdam``) applied to the rows a batch touches only:
untouched rows' moments do not decay, bias correction uses the global step
count, and no weight decay is applied. ``rowwise_adam`` decays every row's
moments each step, so these are different models, not faster ones.

- The fused record: the table, its first moment and its rowwise second
  moment in one (V, 128) float32 record ``[table d | m d | v 1 | pad]``.
  The step is one gather and one scatter of whole records, fed by the
  gradient of the gathered rows (the "tap" cotangent, (tokens * k, d)); no
  dense (V, d) gradient exists.
- The lazy update: a dense (V, d) table and gradient; the touched rows are
  the rows whose gradient is nonzero, compacted to a static capacity.

Plain torch operations throughout; the JAX package runs these outside any
Pallas kernel too.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from recommendations_tpu_torch.nn.functional import sorted_segment_sum

RECORD_LANES = 128


class FusedTableState(NamedTuple):
    count: torch.Tensor  # () int32 global step (bias correction)


class LazyRowState(NamedTuple):
    m: torch.Tensor  # (N, d) first moment
    v: torch.Tensor  # (N, 1) rowwise second moment
    count: torch.Tensor  # () int32 global step (bias correction)


def fused_record_init(
    num_embeddings: int, features: int, generator: torch.Generator, stddev: float = 1.0
) -> torch.Tensor:
    """(V, 128) float32 record on the generator's device: the table columns
    N(0, stddev^2), moments and pad zero. The table is drawn in slices of
    rows straight into the record, so no second full-size tensor is held
    (at V = 10M the record alone is 5.12 GB)."""
    if 2 * features + 1 > RECORD_LANES:
        raise ValueError(f"fused record needs 2*d+1 <= {RECORD_LANES}, got d={features}")
    dev = generator.device
    rec = torch.zeros((num_embeddings, RECORD_LANES), dtype=torch.float32, device=dev)
    step = 1 << 20
    for lo in range(0, num_embeddings, step):
        hi = min(lo + step, num_embeddings)
        rec[lo:hi, :features] = stddev * torch.randn((hi - lo, features), generator=generator, device=dev)
    return rec


def fused_record_table(record: torch.Tensor, features: int) -> torch.Tensor:
    """The (V, d) table view of a fused record."""
    return record[:, :features]


def bias_corrections(count: torch.Tensor, b1: float, b2: float):
    """(1 - b1**count, 1 - b2**count) in float32, as the JAX package forms
    them (``jnp.float32(b) ** count``)."""
    c = count.to(torch.float32)
    return tuple(1.0 - torch.full((), b, dtype=torch.float32, device=c.device) ** c for b in (b1, b2))


@torch.no_grad()
def sparse_fused_adam_update(
    record: torch.Tensor,
    idx_flat: torch.Tensor,
    grad_rows: torch.Tensor,
    state: FusedTableState,
    *,
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[FusedTableState, torch.Tensor]:
    """Rowwise Adam on exactly the rows the batch touched, in place on
    ``record``.

    idx_flat: (M,) row ids, duplicates allowed (a row's gradient is the sum
    over its duplicates, in float32, in their order of occurrence on every
    device); grad_rows: (M, d) gradient of the
    gathered rows. Rows whose summed gradient is exactly zero (masked and
    padding tokens) are skipped. Returns ``(new_state, rows_nan)``:
    ``rows_nan`` is a bool scalar, any non-finite value among the rows
    written this step (the dense NaN check leaves the record out)."""
    d = grad_rows.shape[-1]
    count = state.count + 1
    # sorted distinct ids and each one's gradient, summed in a fixed order
    uniq, acc = sorted_segment_sum(idx_flat, grad_rows.to(torch.float32))
    keep = (acc != 0).any(dim=1)
    rows_idx, g_sum = uniq[keep], acc[keep]

    rows = record[rows_idx]  # one gather of whole records
    t_rows, m_rows, v_row = rows[:, :d], rows[:, d:2 * d], rows[:, 2 * d:2 * d + 1]
    new_m = b1 * m_rows + (1.0 - b1) * g_sum
    g2 = g_sum.square().mean(dim=1, keepdim=True)
    new_v = b2 * v_row + (1.0 - b2) * g2
    c1, c2 = bias_corrections(count, b1, b2)
    mhat = new_m / c1
    vhat = new_v / c2
    new_t = t_rows - learning_rate * mhat / (vhat.sqrt() + eps)

    rows[:, :d] = new_t
    rows[:, d:2 * d] = new_m
    rows[:, 2 * d:2 * d + 1] = new_v
    record[rows_idx] = rows  # one scatter of whole records
    rows_nan = ~torch.isfinite(rows).all()
    return FusedTableState(count=count), rows_nan


def init_lazy_row_state(table: torch.Tensor) -> LazyRowState:
    return LazyRowState(
        m=torch.zeros_like(table),
        v=torch.zeros((table.shape[0], 1), dtype=torch.float32, device=table.device),
        count=torch.zeros((), dtype=torch.int32, device=table.device),
    )


@torch.no_grad()
def lazy_rowwise_adam_update(
    table: torch.Tensor,
    grad: torch.Tensor,
    state: LazyRowState,
    *,
    learning_rate: float,
    capacity: int,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> LazyRowState:
    """One lazy rowwise-Adam step on the rows ``grad`` touches, in place on
    ``table`` and the state's moments.

    The touched rows are those with a nonzero gradient; the first
    ``capacity`` of them in index order are applied (``jnp.nonzero(...,
    size=capacity)``), and rows past it keep their gradient unapplied this
    step."""
    n = table.shape[0]
    cap = int(min(capacity, n))
    count = state.count + 1
    active = (grad != 0).any(dim=1)
    idx = torch.nonzero(active).squeeze(1)[:cap]

    g_rows = grad[idx].to(torch.float32)
    m_rows = state.m[idx].to(torch.float32)
    v_rows = state.v[idx]
    new_m = b1 * m_rows + (1.0 - b1) * g_rows
    g2 = g_rows.square().mean(dim=1, keepdim=True)
    new_v = b2 * v_rows + (1.0 - b2) * g2
    c1, c2 = bias_corrections(count, b1, b2)
    mhat = new_m / c1
    vhat = new_v / c2
    upd = (-learning_rate * mhat / (vhat.sqrt() + eps)).to(table.dtype)

    table.index_add_(0, idx, upd)  # distinct rows (nonzero's): a fixed order
    state.m[idx] = new_m.to(state.m.dtype)
    state.v[idx] = new_v
    return LazyRowState(m=state.m, v=state.v, count=count)
