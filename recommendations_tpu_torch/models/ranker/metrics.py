"""Ranking metrics on a batch: AUC and NDCG.

Port of ``recommendations_tpu/models/ranker/metrics.py``. The ranks come
from a stable sort (``jnp.argsort`` is stable), so tied scores rank by
position, as in the JAX package. As there, every row takes a rank, pad rows
included, before ``valid`` masks them out of the sums: a pad row scored
below a real one moves that row's rank (ROADMAP section 3).
"""

from __future__ import annotations

from typing import Optional

import torch


def binary_auc(scores: torch.Tensor, labels: torch.Tensor, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rank-statistic AUC (Mann-Whitney U) over a batch, float32; 0.5 when
    either class is empty."""
    scores = scores.reshape(-1).float()
    labels = labels.reshape(-1).float()
    valid = torch.ones_like(labels, dtype=torch.bool) if valid is None else valid.reshape(-1)
    pos = (labels > 0.5) & valid
    neg = (labels <= 0.5) & valid
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty_like(scores)
    ranks[order] = torch.arange(1, scores.shape[0] + 1, dtype=torch.float32, device=scores.device)
    # the counts in float64, as JAX's int64 sums and python floats give them
    n_pos, n_neg = pos.sum().double(), neg.sum().double()
    u = torch.where(pos, ranks, 0.0).sum().double() - n_pos * (n_pos + 1) / 2.0
    auc = u / torch.clamp_min(n_pos * n_neg, 1.0)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, 0.5).float()


def ndcg_at_k(scores: torch.Tensor, relevance: torch.Tensor, k: int) -> torch.Tensor:
    """NDCG@k per row of (B, L) score and relevance matrices, averaged."""
    k = min(k, scores.shape[-1])
    top = torch.argsort(-scores, dim=-1, stable=True)[..., :k]
    gains = torch.take_along_dim(relevance, top, dim=-1)
    discounts = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32, device=scores.device))
    dcg = torch.sum((2.0**gains - 1.0) * discounts, dim=-1)
    ideal = torch.sort(relevance, dim=-1, descending=True).values[..., :k]
    idcg = torch.sum((2.0**ideal - 1.0) * discounts, dim=-1)
    return torch.mean(dcg / torch.clamp_min(idcg, 1e-9))
