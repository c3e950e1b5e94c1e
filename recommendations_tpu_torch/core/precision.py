"""Mixed-precision policy.

Port of ``recommendations_tpu/core/precision.py``: parameters and optimizer
state in float32, activations and matmuls in bfloat16, reductions (losses,
norms, softmax sums) in float32; bf16 needs no loss scaling.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        """Every floating tensor of a nested dict, list or tuple cast to the
        compute dtype; anything else as it is."""
        if isinstance(tree, torch.Tensor):
            return tree.to(self.compute_dtype) if tree.is_floating_point() else tree
        if isinstance(tree, dict):
            return {k: self.cast_to_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_to_compute(v) for v in tree)
        return tree


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)
