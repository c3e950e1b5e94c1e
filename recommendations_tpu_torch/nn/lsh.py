"""The LSH and numeric-vector embedding library.

Port of ``recommendations_tpu/nn/lsh.py``: random-projection cosine-LSH
embeddings of float vectors (``CosineVectorEmbedding``, and the sign bits
of ``SimhashVectorIndexer``), the quantile scalar mappers
(``QuantileMapper``, ``DenseMapper``) and the learnable Gaussian
soft-binning embeddings (``CosineLinear``, ``LearnableCosineVectorEmbedding``,
``ProbabilityVectorEmbedding``). A fixed random projection is a registered
buffer (the JAX package keeps it in the ``constants`` collection), so it
travels with the weights; a module keeps the names of the JAX package's
submodules and variables (``q_<name>``, ``emb_<i>``, ``proj``, ``emb``,
``mean``), so ``models.lthm.convert.lsh_state_dict_from_jax`` maps them one
to one. Weights are drawn from the generator given; JAX's come across
through the converter.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from recommendations_tpu_torch.nn.attention import Dense
from recommendations_tpu_torch.nn.embeddings import init_param
from recommendations_tpu_torch.nn.functional import cast_param, l2_normalize


def _bucketize(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """#{b : b < x}, i.e. ``torch.bucketize(right=False)``, as the JAX
    package's comparison count."""
    return torch.sum(boundaries < x[..., None], dim=-1)


class SimhashVectorIndexer(nn.Module):
    """The signs of ``n_proj`` fixed random projections, packed into an
    int64 code: bit i is projection i's ``> 0``."""

    def __init__(self, inp_dim: int, generator: torch.Generator, n_proj: int = 16):
        super().__init__()
        proj = torch.randn((inp_dim, n_proj), generator=generator, device=generator.device)
        self.register_buffer("projection_mat", proj / math.sqrt(float(inp_dim)))
        self.register_buffer("bits", torch.arange(n_proj, dtype=torch.int64, device=generator.device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = (x @ self.projection_mat) > 0
        return torch.sum(z.to(torch.int64) << self.bits, dim=-1)


class CosineVectorEmbedding(nn.Module):
    """L2-normalize, project onto n_proj fixed unit directions, bucketize each
    projection into num_bins+1 buckets on [-1, 1], and sum the rows of the
    (projection, bucket) table (EmbeddingBag(sum))."""

    def __init__(
        self,
        inp_dim: int,
        features: int,
        generator: torch.Generator,
        n_proj: int = 16,
        num_bins: int = 20,
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        self.n_proj, self.num_bins = n_proj, num_bins
        self.compute_dtype = compute_dtype
        proj = torch.randn((inp_dim, n_proj), generator=generator, device=generator.device)
        self.register_buffer("projection_mat", l2_normalize(proj, dim=0))
        resolution = 2.0 / float(num_bins)
        grid = (np.linspace(-1.0, 1.0, num_bins + 1)[:-1] + 0.5 * resolution).astype(np.float32)
        self.register_buffer("grid", torch.from_numpy(grid).to(generator.device), persistent=False)
        self.embedding = init_param(((num_bins + 1) * n_proj, features), 1.0, generator)

    def buckets(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n_proj) bucket of each projection, in [0, num_bins]."""
        z = l2_normalize(x) @ self.projection_mat
        return _bucketize(z, self.grid)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.buckets(x)
        nb1 = self.num_bins + 1
        # EmbeddingBag(sum) as one matmul of the (..., n_proj * (nb+1))
        # indicator with the table, in the compute dtype with f32
        # accumulation, as the JAX package computes it; gathering the rows
        # instead would move n_proj full rows per token
        onehot = (b[..., None] == torch.arange(nb1, device=b.device)).to(self.compute_dtype)
        onehot = onehot.reshape(*b.shape[:-1], self.n_proj * nb1)
        return (onehot @ cast_param(self.embedding, self.compute_dtype)).to(self.embedding.dtype)


class QuantileMapper(nn.Module):
    """The bucket of ``x`` among the quantiles, as a centred scalar:
    bucket / (len(quantiles) + 1) - 0.5, in [-0.5, 0.5]."""

    def __init__(self, quantiles: Sequence[float], device=None):
        super().__init__()
        self.n_bins = len(quantiles) + 1
        self.register_buffer("quantiles", torch.tensor(list(quantiles), dtype=torch.float32, device=device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bins = _bucketize(x.float(), self.quantiles)
        return bins.float() / float(self.n_bins) - 0.5


class DenseMapper(nn.Module):
    """Every numeric feature of ``stats`` (name -> quantiles) through its
    ``QuantileMapper`` (``q_<name>``), concatenated in ``stats``' order, and
    the sum of the ``CosineVectorEmbedding``s (``emb_<i>``) of that vector:
    (batch, features)."""

    def __init__(self, stats: Dict[str, Sequence[float]], features: int, n_projs: Sequence[int],
                 num_bins: Sequence[int], generator: torch.Generator):
        super().__init__()
        assert len(n_projs) == len(num_bins)
        self.names = list(stats)
        for name in self.names:
            self.add_module(f"q_{name}", QuantileMapper(tuple(stats[name]), generator.device))
        self.n_emb = len(n_projs)
        for i, (npj, nb) in enumerate(zip(n_projs, num_bins)):
            self.add_module(f"emb_{i}", CosineVectorEmbedding(len(stats), features, generator, n_proj=npj,
                                                              num_bins=nb))

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        parts = [getattr(self, f"q_{name}")(batch[name].reshape(-1, 1)) for name in self.names]
        x = torch.cat(parts, dim=1)[:, None, :]  # (batch, 1, n_features)
        out = None
        for i in range(self.n_emb):
            emb = getattr(self, f"emb_{i}")(x)
            out = emb if out is None else out + emb
        return out[:, 0, :]


class CosineLinear(nn.Module):
    """The cosine similarity of the input with each weight row: the
    L2-normalized input times the L2-normalized rows of ``weight``
    (out_dim, inp_dim), initialized N(0, 1/inp_dim)."""

    def __init__(self, inp_dim: int, out_dim: int, generator: torch.Generator):
        super().__init__()
        self.weight = init_param((out_dim, inp_dim), 1.0 / math.sqrt(float(inp_dim)), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(x) @ l2_normalize(self.weight, dim=-1).T


def _topk_sparsify(act: torch.Tensor, top_k: Optional[int]) -> torch.Tensor:
    """Zero every value below the k-th largest of its row; values tied with
    the k-th all stay."""
    if top_k is None:
        return act
    thresh = torch.topk(act, top_k, dim=-1).values[..., -1:]
    return torch.where(act < thresh, torch.zeros((), dtype=act.dtype, device=act.device), act)


class _SoftBinning(nn.Module):
    """Gaussian soft binning around the learned bin centres ``mean``, the
    top-k of each row kept, L2-normalized, then ``emb`` (a bias-free dense
    layer, weight (features, inputs))."""

    def _embed(self, diff: torch.Tensor) -> torch.Tensor:
        act = torch.exp(-0.5 * diff * diff / self.sigma2)
        return l2_normalize(_topk_sparsify(act, self.top_k))


class LearnableCosineVectorEmbedding(_SoftBinning):
    """``proj`` (a ``CosineLinear`` to ``n_proj`` directions), each
    projection soft-binned over ``num_bins`` centres on [-1, 1] (σ =
    sigma_inflation_factor * 2 / num_bins), top-k sparsified, flattened, and
    ``emb``."""

    def __init__(self, inp_dim: int, features: int, generator: torch.Generator, n_proj: int = 16,
                 num_bins: int = 20, sigma_inflation_factor: float = 1.0, top_k: Optional[int] = None):
        super().__init__()
        self.n_proj, self.num_bins = n_proj, num_bins
        self.top_k = None if top_k is None else min(top_k, num_bins)
        self.sigma2 = (sigma_inflation_factor * 2.0 / num_bins) ** 2
        self.proj = CosineLinear(inp_dim, n_proj, generator)
        self.mean = nn.Parameter(
            2.0 * torch.rand((1, 1, n_proj, num_bins), generator=generator, device=generator.device) - 1.0)
        self.emb = _dense(n_proj * num_bins, features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.proj(x)  # (..., n_proj)
        act = self._embed(z[..., None] - self.mean)
        return self.emb(act.reshape(*act.shape[:-2], self.n_proj * self.num_bins))


class ProbabilityVectorEmbedding(_SoftBinning):
    """A probability (..., 1) soft-binned over ``num_bins`` centres on [0, 1]
    (σ = sigma_inflation_factor / num_bins), top-k sparsified, and
    ``emb``."""

    def __init__(self, features: int, generator: torch.Generator, num_bins: int = 10,
                 sigma_inflation_factor: float = 1.0, top_k: Optional[int] = None):
        super().__init__()
        self.top_k = None if top_k is None else min(top_k, num_bins)
        self.sigma2 = (sigma_inflation_factor * 1.0 / num_bins) ** 2
        self.mean = nn.Parameter(torch.rand((1, num_bins), generator=generator, device=generator.device))
        self.emb = _dense(num_bins, features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != 1:
            raise ValueError("ProbabilityVectorEmbedding expects input dim 1")
        return self.emb(self._embed(x - self.mean))


def _dense(in_features: int, out_features: int, generator: torch.Generator) -> Dense:
    """flax's ``Dense(use_bias=False)`` in float32."""
    return Dense(in_features, out_features, generator, use_bias=False)
