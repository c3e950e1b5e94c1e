"""Parameter partitioning rules: a regex over each parameter's path gives
its partition spec, and each rank keeps its slice.

Port of ``recommendations_tpu/core/partitioning.py``. A spec is a tuple with
one entry per leading dimension, a mesh axis name or None (JAX's
``PartitionSpec``); ``()`` replicates. The rules are matched against the
JAX package's '/'-joined path names (``jax_path`` maps a state-dict key to
its path as ``models/lthm/convert.py`` does the other way), the first match
wins and no match replicates.

``shard_params`` and ``shard_opt_state`` keep this rank's slice of every
sharded leaf: block ``mesh.index(axis)`` of ``mesh.size(axis)`` along each
dimension its spec names an axis for. ``opt_state_specs`` gives each
optimizer moment its parameter's spec, found by path suffix and trimmed
to the moment's rank (a rowwise (N, 1) second moment still shards its
rows).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

Spec = Tuple[Optional[str], ...]


def P(*axes: Optional[str]) -> Spec:
    """A partition spec: one mesh axis (or None) per leading dimension."""
    return tuple(axes)


def jax_path(key: str, ndim: int) -> str:
    """A state-dict key as the JAX package's parameter path: dots become
    '/', and a Dense or LayerNorm ``weight`` its ``kernel`` (2-D) or
    ``scale``."""
    parts = key.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel" if ndim == 2 else "scale"
    return "/".join(parts)


class PartitionRules:
    def __init__(self, rules: Sequence[Tuple[str, Spec]]):
        self._rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]

    def spec_for(self, path: str) -> Spec:
        for pat, spec in self._rules:
            if pat.fullmatch(path):
                return spec
        return ()

    def tree_specs(self, params: Mapping[str, torch.Tensor]) -> Dict[str, Spec]:
        """State-dict key -> spec, matched on its JAX path."""
        return {k: self.spec_for(jax_path(k, v.ndim)) for k, v in params.items()}


def shard_slice(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a view where it can)."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.size(axis) == 1:
            continue
        n = mesh.size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} not divisible by {axis}={n}")
        x = x.chunk(n, dim=dim)[mesh.index(axis)]
    return x


def shard_params(mesh, params: Mapping[str, torch.Tensor], rules: PartitionRules) -> Dict[str, torch.Tensor]:
    """Each parameter's slice for this rank, by key."""
    specs = rules.tree_specs(params)
    return {k: shard_slice(v, specs[k], mesh) for k, v in params.items()}


def opt_state_specs(
    opt_state: Mapping[str, torch.Tensor], params: Mapping[str, object], rules: PartitionRules
) -> Dict[str, Spec]:
    """Spec per optimizer-state leaf, both keyed by '/'-joined paths:
    a leaf whose path is a parameter's path, or ends in '/' + one, takes
    that parameter's spec (the longest such path first), trimmed to the
    leaf's rank; any other leaf (step counters) replicates."""
    param_specs = {p: rules.spec_for(p) for p in params}
    ordered = sorted(param_specs.items(), key=lambda kv: -len(kv[0]))
    out: Dict[str, Spec] = {}
    for path, leaf in opt_state.items():
        spec: Spec = ()
        for param_path, pspec in ordered:
            if path == param_path or path.endswith("/" + param_path):
                spec = tuple(pspec)[: getattr(leaf, "ndim", 0)]
                break
        out[path] = spec
    return out


def shard_opt_state(mesh, opt_state: Mapping[str, torch.Tensor], params: Mapping[str, object],
                    rules: PartitionRules) -> Dict[str, torch.Tensor]:
    """Each optimizer-state leaf's slice for this rank, sharded like its
    parameter."""
    specs = opt_state_specs(opt_state, params, rules)
    return {k: shard_slice(v, specs[k], mesh) if torch.is_tensor(v) else v for k, v in opt_state.items()}
