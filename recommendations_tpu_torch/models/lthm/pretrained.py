"""The frozen pretrained compressed product-embedding module.

Port of ``recommendations_tpu/models/lthm/pretrained.py``: a KShift
reconstruction table and a KShift (k = 4) + MLP mask model, whose output is
``sigmoid(mask_mlp(kshift_mask(x))) * kshift_emb(x)``. Every weight is a
registered buffer (the JAX package keeps them in the frozen ``constants``
collection), so the training step never takes their gradient.
``tools/embedding_module_gen.py`` trains them; ``load_pretrained_constants``
copies an artifact (a dict of numpy arrays: the port's own, or a JAX Orbax
artifact as the JAX package's ``load_artifact`` returns it) into a module.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from recommendations_tpu_torch.nn.embeddings import kshift_row_indices
from recommendations_tpu_torch.nn.functional import l2_normalize, quick_gelu

MASK_SHIFTS = 4
CONSTANTS = ("emb_table", "mask_table", "mask_w1", "mask_b1", "mask_w2", "mask_b2")


def mask_logits(ids: torch.Tensor, mask_table, w1, b1, w2, b2) -> torch.Tensor:
    """The mask model's logit per id: KShift(k=4) rows summed over 2 (=
    sqrt(4)), then quick_gelu(m @ w1 + b1) @ w2 + b2; shape ids.shape."""
    midx = kshift_row_indices(ids, mask_table.shape[0], MASK_SHIFTS)
    m = mask_table[midx].sum(dim=-2) / 2.0
    return (quick_gelu(m @ w1 + b1) @ w2 + b2)[..., 0]


class PretrainedProductEmbedding(nn.Module):
    """out = sigmoid(mask_mlp(kshift_mask(x))) * kshift_emb(x), all frozen.
    The buffers start as the JAX module's initializers draw them (normal
    tables and weights, zero biases), from ``generator``."""

    def __init__(
        self,
        num_embeddings: int,
        features: int,
        generator: torch.Generator,
        num_shifts: int = 16,
        normalize_output: bool = True,
        mask_emb_dim: int = 4,
        mask_hidden: int = 64,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.num_shifts = num_shifts
        self.normalize_output = normalize_output
        self.compute_dtype = compute_dtype
        dev = generator.device

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        self.register_buffer("emb_table", normal(num_embeddings, features))
        self.register_buffer("mask_table", normal(num_embeddings, mask_emb_dim))
        self.register_buffer("mask_w1", normal(mask_emb_dim, mask_hidden))
        self.register_buffer("mask_b1", torch.zeros(mask_hidden, device=dev))
        self.register_buffer("mask_w2", normal(mask_hidden, 1))
        self.register_buffer("mask_b2", torch.zeros(1, device=dev))

    def forward(self, ids: torch.Tensor, tap: Optional[torch.Tensor] = None) -> torch.Tensor:
        if tap is not None:
            raise ValueError("the pretrained module is frozen: it takes no taps")
        idx = kshift_row_indices(ids, self.num_embeddings, self.num_shifts)
        if self.compute_dtype is not None:
            # the rows in the compute dtype, summed with f32 accumulation and
            # one rounding back, as KShiftEmbedding's
            rows = self.emb_table.to(self.compute_dtype)[idx]
            emb = rows.float().sum(dim=-2).to(self.compute_dtype).float()
        else:
            emb = self.emb_table[idx].sum(dim=-2)
        if self.normalize_output:
            emb = l2_normalize(emb)
        else:
            emb = emb / math.sqrt(self.num_shifts)
        gate = torch.sigmoid(mask_logits(ids, self.mask_table, self.mask_w1, self.mask_b1,
                                         self.mask_w2, self.mask_b2))
        return gate[..., None] * emb


def load_pretrained_constants(module: nn.Module, artifact: Mapping[str, np.ndarray],
                              module_path: str = "product_emb_module") -> None:
    """Copy an artifact's arrays into the ``PretrainedProductEmbedding`` at
    ``module_path`` of ``module``, in place; a shape that differs raises."""
    target = module.get_submodule(module_path)
    for name in CONSTANTS:
        if name not in artifact:
            continue
        buf = getattr(target, name)
        value = torch.as_tensor(np.asarray(artifact[name]))
        if tuple(value.shape) != tuple(buf.shape):
            raise ValueError(f"{module_path}.{name}: artifact shape {tuple(value.shape)} vs module "
                             f"{tuple(buf.shape)}")
        buf.copy_(value.to(buf.dtype))
