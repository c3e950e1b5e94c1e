"""JAX variables -> the port's ``state_dict``.

Takes flax variables as nested dicts of numpy arrays (``params`` and
``constants``; the caller converts device arrays with ``np.asarray``, so
this module never sees JAX). Module paths carry over unchanged, joined by
dots; leaf names map as flax ``Dense``/``LayerNorm`` to PyTorch:
``kernel`` (in, out) -> ``weight`` (out, in), ``scale`` -> ``weight``.
Every other leaf keeps its name. Any key the module lacks, any key it has
that the variables do not fill, and any shape that differs is an error.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

_RENAME = {"kernel": "weight", "scale": "weight"}


def _flatten(tree, prefix: Tuple[str, ...], out: Dict[Tuple[str, ...], np.ndarray]) -> None:
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict):
            _flatten(val, path, out)
        else:
            if path in out:
                raise KeyError(f"{'/'.join(path)} appears in two collections")
            out[path] = np.asarray(val)


def state_dict_from_jax(variables: dict, module: nn.Module) -> Dict[str, torch.Tensor]:
    """``variables`` -> a state_dict for ``module`` (strict: raises on any
    missing, unused or misshapen entry)."""
    flat: Dict[Tuple[str, ...], np.ndarray] = {}
    for collection in variables.values():
        _flatten(collection, (), flat)

    expected = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        leaf = path[-1]
        key = ".".join(path[:-1] + (_RENAME.get(leaf, leaf),))
        if leaf == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense kernel, got {arr.shape}")
            arr = arr.T
        if key not in expected:
            raise KeyError(f"JAX variable {'/'.join(path)} -> {key}: the module has no such entry")
        ref = expected[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX shape {arr.shape} vs module shape {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(arr, order="C")).to(ref.dtype)

    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"module entries the JAX variables do not fill: {missing}")
    return out
