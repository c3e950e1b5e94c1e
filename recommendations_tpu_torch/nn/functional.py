"""Stateless ops shared across the layer library.

Port of ``recommendations_tpu/nn/functional.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), with the max taken on the squared norm so the
    sqrt never sees 0 (exact-zero rows are routine: masked embeddings)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp_min(sq, eps * eps))


def l2_normalize_f32acc(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``l2_normalize`` with the reduction in float32 and the output in the
    input dtype."""
    xf = x.float()
    sq = torch.sum(xf * xf, dim=dim, keepdim=True)
    return (xf / torch.sqrt(torch.clamp_min(sq, eps * eps))).to(x.dtype)
