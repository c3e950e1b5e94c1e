"""Stateless ops shared across the layer library.

Port of ``recommendations_tpu/nn/functional.py``, and ``cast_param``,
the cast of a parameter for a product in a lower precision.
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


def sorted_segment_sum(idx: torch.Tensor, rows: torch.Tensor):
    """Sum of the rows that share an index, in a fixed order: (sorted distinct
    indices, (U, d) sums in ``rows``' dtype). A stable sort keeps each
    index's rows in their order of occurrence, and each segment is summed
    one row after the other, every add rounded to the dtype, on any device.
    (An ``index_add_`` or accumulating ``index_put_`` on a CUDA tensor adds
    in an order it does not fix, or in float32.)"""
    idx = idx.reshape(-1).to(torch.int64)
    rows = rows.reshape(idx.shape[0], -1)
    if idx.numel() == 0:
        return idx, rows[:0]
    sorted_idx, order = torch.sort(idx, stable=True)
    uniq, counts = torch.unique_consecutive(sorted_idx, return_counts=True)
    sums = torch.segment_reduce(rows[order], "sum", lengths=counts, axis=0, unsafe=True)
    return uniq, sums


class _CapGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / torch.clamp_min(torch.linalg.vector_norm(g), 1e-12)


def cap_gradients(x: torch.Tensor) -> torch.Tensor:
    """The identity forward; the backward divides the cotangent by its L2
    norm over the whole tensor (at least 1e-12), as the JAX package's
    ``jnp.linalg.norm(g)``: used to balance the gradients flowing into a
    shared trunk under multi-task losses."""
    return _CapGradients.apply(x)


def note_product_dtype(p: torch.Tensor, dtype: torch.dtype) -> None:
    """Note on a parameter that its gradient comes out of a product in the
    narrower float ``dtype``, rounded to it (``cast_param``)."""
    if (dtype != p.dtype and dtype.is_floating_point and dtype.itemsize < p.dtype.itemsize
            and isinstance(p, torch.nn.Parameter) and p.requires_grad):
        p.product_dtype = dtype


def cast_param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p.to(dtype)``, for a product in ``dtype``. A parameter cast to a
    narrower float gets its gradient out of that product rounded to
    ``dtype``; over a mesh, the JAX package's gradient (XLA's partitioned
    backward, compiled or op by op) is each device's rounded partial,
    summed, and rounded to ``dtype`` once more. The parameter keeps
    ``dtype`` as ``product_dtype``, from which ``train.step.reduce_gradients``
    rounds the sum over the ranks."""
    note_product_dtype(p, dtype)
    return p.to(dtype)
