"""Cosine-LSH embedding of float vectors.

Port of ``recommendations_tpu/nn/lsh.py``'s ``_bucketize`` and
``CosineVectorEmbedding``. The fixed random projection is a registered
buffer (the JAX package keeps it in the ``constants`` collection), so it
travels with the weights.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from recommendations_tpu_torch.nn.embeddings import init_param
from recommendations_tpu_torch.nn.functional import l2_normalize


def _bucketize(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """#{b : b < x}, i.e. ``torch.bucketize(right=False)``."""
    return torch.sum(boundaries < x[..., None], dim=-1)


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
        return (onehot @ self.embedding.to(self.compute_dtype)).to(self.embedding.dtype)
