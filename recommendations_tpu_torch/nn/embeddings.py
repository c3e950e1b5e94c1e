"""Hash-embedding layers.

Port of ``recommendations_tpu/nn/embeddings.py``, every layer of it:
FlatEmbedding, QREmbedding, KShiftEmbedding (a dense table, or the fused
(V, 128) record of ``train/sparse_table.py``), HistogramEmbedding,
PatternFromTimelocal, NAImputationPlusQuantileEmbedding and the QuickGELU
MLP.

Ids are int64 over the full range. The KShift hash uses an unsigned 64-bit
rotation and an unsigned mod; PyTorch's uint64 support is partial, so both
are emulated on int64 bit patterns and agree bit for bit with the reference.

Small tables return their rows rounded to the compute dtype, as the JAX
package's one-hot matmul lookup does. When a gradient is taken the lookup is
that one-hot matmul, whose backward is a matmul too (the backward of
indexing serializes the many repeated rows of a small table, a 4-row table
read 16k times per batch); otherwise it is indexing, which gives the same
rows in fewer launches. A larger table's gather (``gather_rows``) sums a
row's duplicate gradients in their order of occurrence, on every device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from recommendations_tpu_torch.nn.attention import Dense
from recommendations_tpu_torch.nn.functional import (
    cast_param,
    l2_normalize,
    note_product_dtype,
    quick_gelu,
    sorted_segment_sum,
)
from recommendations_tpu_torch.train.sparse_table import fused_record_init

# Tables up to this many rows are looked up by a one-hot matmul; larger ones
# by indexing (exact rows).
ONEHOT_LOOKUP_MAX_ROWS = 4096


def init_param(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    """N(0, std^2) parameter on the generator's device."""
    return nn.Parameter(
        torch.randn(shape, generator=generator, device=generator.device) * std
    )


def _check_int(ids: torch.Tensor) -> None:
    if ids.dtype.is_floating_point or ids.dtype.is_complex or ids.dtype == torch.bool:
        raise TypeError(f"hash ids must be integers, got {ids.dtype}")


def small_table_lookup(
    table: torch.Tensor, idx: torch.Tensor, compute_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """``table[idx]``; up to ONEHOT_LOOKUP_MAX_ROWS rows, rounded to
    ``compute_dtype`` (the table's dtype when None), and as a one-hot matmul
    in that dtype when the table's gradient is taken."""
    n = table.shape[0]
    if n > ONEHOT_LOOKUP_MAX_ROWS:
        return gather_rows(table, idx)
    ct = compute_dtype or table.dtype
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx].to(ct).to(table.dtype)
    onehot = (idx[..., None] == torch.arange(n, device=idx.device)).to(ct)
    return (onehot @ cast_param(table, ct)).to(table.dtype)


def kshift_row_indices(ids: torch.Tensor, num_embeddings: int, num_shifts: int) -> torch.Tensor:
    """Row c of each id is rotl64(id, c) mod N, unsigned; shape ids.shape + (k,).

    Emulated on int64: the logical right shift is an arithmetic shift and a
    mask; ``u mod N`` of a negative x (u = x + 2**64) is
    ``(x mod N + 2**64 mod N) mod N``.
    """
    _check_int(ids)
    x = ids.to(torch.int64)
    rots = [x]
    for c in range(1, num_shifts):
        low = (x >> (64 - c)) & ((1 << c) - 1)
        rots.append((x << c) | low)
    s = torch.stack(rots, dim=-1)
    n = int(num_embeddings)
    r = s.remainder(n)
    return torch.where(s < 0, (r + (2**64 % n)).remainder(n), r)


class FlatEmbedding(nn.Module):
    """``table[id mod N]`` (floor mod, as ``jnp.mod``)."""

    def __init__(
        self,
        num_embeddings: int,
        features: int,
        generator: torch.Generator,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.compute_dtype = compute_dtype
        self.embedding = init_param((num_embeddings, features), 1.0, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        _check_int(ids)
        idx = ids.to(torch.int64).remainder(self.num_embeddings)
        return small_table_lookup(self.embedding, idx, self.compute_dtype)


class _GatherRowsLowp(torch.autograd.Function):
    """``table[idx]`` rounded to a lower dtype, whose table gradient sums a
    row's duplicate cotangents in that dtype, in their order of occurrence
    on every device (``nn.functional.sorted_segment_sum``), and converts once
    to the table's: the JAX package casts the table before its gather, so its
    scatter-add (``ops/bucketed_scatter.py``) runs in the compute dtype.
    (The cast and the gather commute in the forward, so only the gathered
    rows are cast here.)"""

    @staticmethod
    def forward(ctx, table, idx, dtype):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        ctx.table_dtype = table.dtype
        return table[idx].to(dtype)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        d = g.shape[-1]
        rows, sums = sorted_segment_sum(idx, g.reshape(-1, d))
        acc = torch.zeros((ctx.num_rows, d), dtype=g.dtype, device=g.device)
        acc[rows] = sums  # distinct rows: no accumulation
        return acc.to(ctx.table_dtype), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, whose table gradient sums a row's duplicates in a
    fixed order (``_GatherRowsLowp`` at the table's own dtype)."""
    return _GatherRowsLowp.apply(table, idx, table.dtype)


class QREmbedding(nn.Module):
    """Quotient-remainder embedding: two tables of isqrt(N) rows, ``emb_q``
    read at (x // div) mod div and ``emb_r`` at x mod div, x = id mod div**2,
    the two rows summed; optionally L2-normalized."""

    def __init__(
        self,
        num_embeddings: int,
        features: int,
        generator: torch.Generator,
        normalize_output: bool = False,
    ):
        super().__init__()
        self.div = math.isqrt(num_embeddings)
        self.normalize_output = normalize_output
        self.emb_q = init_param((self.div, features), 1.0, generator)
        self.emb_r = init_param((self.div, features), 1.0, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        _check_int(ids)
        div = self.div
        x = ids.to(torch.int64).remainder(div * div)
        out = gather_rows(self.emb_q, (x // div).remainder(div)) + gather_rows(self.emb_r, x.remainder(div))
        return l2_normalize(out) if self.normalize_output else out


class KShiftEmbedding(nn.Module):
    """k-shift parameter-shared embedding: each id sums k rotated-hash rows of
    one table, scaled by 1/sqrt(k) or L2-normalized.

    With ``fused_record`` the parameter is the (V, 128) float32 record
    ``[table d | m d | v 1 | pad]`` that ``train/sparse_table.py`` updates
    outside autograd: the lookup gathers rows of the detached record, keeps
    the first d lanes, casts them to the compute dtype and adds ``tap``, a
    zero tensor whose gradient is then the gradient of the gathered rows
    (the JAX package's tap cotangent)."""

    def __init__(
        self,
        num_embeddings: int,
        features: int,
        generator: torch.Generator,
        num_shifts: int = 8,
        normalize_output: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        fused_record: bool = False,
    ):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.num_shifts = num_shifts
        self.normalize_output = normalize_output
        self.compute_dtype = compute_dtype
        self.fused_record = fused_record
        if fused_record:
            self.embedding = nn.Parameter(
                fused_record_init(num_embeddings, features, generator), requires_grad=False
            )
        else:
            self.embedding = init_param((num_embeddings, features), 1.0, generator)

    def forward(self, ids: torch.Tensor, tap: Optional[torch.Tensor] = None) -> torch.Tensor:
        idx = kshift_row_indices(ids, self.num_embeddings, self.num_shifts)
        if self.fused_record:
            rows = self.embedding.detach()[:, : self.features][idx]
            if self.compute_dtype is not None:
                rows = rows.to(self.compute_dtype)
            if tap is not None:
                rows = rows + tap.to(rows.dtype)
        elif self.compute_dtype is not None and self.compute_dtype != self.embedding.dtype:
            note_product_dtype(self.embedding, self.compute_dtype)
            rows = _GatherRowsLowp.apply(self.embedding, idx, self.compute_dtype)
        else:
            rows = self.embedding[idx]  # (..., k, d)
        if self.compute_dtype is not None:
            # the rows are in the compute dtype; the reference sums them with
            # f32 accumulation and one rounding back to the compute dtype
            x = rows.float().sum(dim=-2).to(self.compute_dtype).float()
        else:
            x = rows.sum(dim=-2)
        if self.normalize_output:
            return l2_normalize(x)
        return x / math.sqrt(self.num_shifts)


class HistogramEmbedding(nn.Module):
    """Bucketized-scalar embedding over [lo, hi] with num_bins bins (values
    clipped into range)."""

    def __init__(
        self,
        lo: float,
        hi: float,
        num_bins: int,
        features: int,
        generator: torch.Generator,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.lo, self.hi, self.num_bins = lo, hi, num_bins
        self.compute_dtype = compute_dtype
        self.embedding = init_param((num_bins, features), 0.02, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        frac = (x.float() - self.lo) / (self.hi - self.lo)
        idx = torch.floor(frac * self.num_bins).to(torch.int64).clamp(0, self.num_bins - 1)
        return small_table_lookup(self.embedding, idx, self.compute_dtype)


class PatternFromTimelocal(nn.Module):
    """Periodic pattern embedding of an epoch timestamp: (t // div) % mod."""

    def __init__(
        self,
        div: int,
        mod: int,
        features: int,
        generator: torch.Generator,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.div, self.mod, self.features = div, mod, features
        self.compute_dtype = compute_dtype
        if features > 0:
            self.embedding = init_param((mod, features), 1.0, generator)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        idx = torch.remainder(t.to(torch.int64) // self.div, self.mod)
        if self.features <= 0:
            return idx.to(torch.int32)
        return small_table_lookup(self.embedding, idx, self.compute_dtype)


class NAImputationPlusQuantileEmbedding(nn.Module):
    """A learned scalar per quantile bucket (initialized to the centred
    bucket fractions), bucketized by counting the quantiles below x; values
    with ``x - na_value < eps`` map to the learned ``na_param``. The NA test
    is the JAX package's, one-sided: every x below ``na_value`` counts as NA
    too (ROADMAP section 3)."""

    def __init__(self, na_value: float, quantiles: Tuple[float, ...], eps: float = 1e-6, device=None):
        super().__init__()
        n = len(quantiles)
        self.na_value, self.eps = na_value, eps
        self.register_buffer("quantiles", torch.tensor(quantiles, dtype=torch.float32, device=device), persistent=False)
        self.embedding = nn.Parameter((torch.arange(0, n - 1, dtype=torch.float32, device=device) / n - 0.5)[:, None])
        self.na_param = nn.Parameter(torch.zeros(1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        n = self.quantiles.shape[0]
        idx = (self.quantiles < x[..., None]).sum(-1).clamp(0, n - 2)
        y = self.embedding[idx]
        is_na = (x - self.na_value) < self.eps
        return torch.where(is_na[..., None], self.na_param, y)


class MLP(nn.Module):
    """QuickGELU-gated MLP: a Dense and quick-GELU per ``gate_sizes``, then
    a Dense to ``out_dim``; flax's auto names ``Dense_{i}``."""

    def __init__(
        self,
        in_features: int,
        out_dim: int,
        generator: torch.Generator,
        gate_sizes: Sequence[int] = (),
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        widths = [in_features, *gate_sizes, out_dim]
        self.n = len(widths) - 1
        for i in range(self.n):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1], generator, use_bias, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n - 1):
            x = quick_gelu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n - 1}")(x)
