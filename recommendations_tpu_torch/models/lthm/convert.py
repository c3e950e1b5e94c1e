"""JAX state -> the port's: variables, the training aux state, the optimizer
and table states.

Takes flax variables as nested dicts of numpy arrays (``params`` and
``constants``; the caller converts device arrays with ``np.asarray``, so
this module never sees JAX). Module paths carry over unchanged, joined by
dots; leaf names map as flax ``Dense``/``LayerNorm`` to PyTorch:
``kernel`` (in, out) -> ``weight`` (out, in), ``scale`` -> ``weight``.
Every other leaf keeps its name. Any key the module lacks, any key it has
that the variables do not fill, and any shape that differs is an error.

The same mapping carries optax AdamW's ``mu`` and ``nu`` (trees shaped like
``params``) and ``count`` into a ``torch.optim.AdamW``'s state,
``rowwise_adam``'s ``{"mu", "nu", "count"}`` (the ``EMB_TABLE`` group of
``multi_transform``; ``nu`` is (N, 1)) into a ``RowwiseAdam``'s, the LTHM
aux state (logQ ``b``, ``a``, ``hash_offsets`` and ``batch_idx``) into the
port's ``LTHMAuxState``, and the table update states (``FusedTableState``,
``LazyRowState``) into the port's. The fused (V, 128) record is the table
parameter itself and goes across with the variables.
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
        elif isinstance(val, tuple) and not val:
            continue  # optax's MaskedNode: a parameter outside the optimizer group
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
    return _convert(flat, module.state_dict())


def lsh_state_dict_from_jax(variables: dict, module: nn.Module) -> Dict[str, torch.Tensor]:
    """The variables of one of ``nn/lsh.py``'s layers (its ``params`` and
    its ``constants``, the fixed projections) -> the layer's state_dict,
    names one to one (``q_<name>``, ``emb_<i>``, ``proj``, ``emb``,
    ``mean``, ``projection_mat``; a Dense ``kernel`` transposed into
    ``weight``). Strict: any other collection, and any missing, unused or
    misshapen entry, raises."""
    other = sorted(set(variables) - {"params", "constants"})
    if other:
        raise KeyError(f"collections an LSH layer does not hold: {other}")
    return state_dict_from_jax(variables, module)


def _convert(
    flat: Dict[Tuple[str, ...], np.ndarray], expected: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
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


def _moments(mu: dict, nu: dict, module: nn.Module, optimizer, rowwise: bool):
    params = {
        name: p for name, p in module.named_parameters()
        if any(p is q for g in optimizer.param_groups for q in g["params"])
    }
    expected_mu = {name: p.detach() for name, p in params.items()}
    expected_nu = {
        name: p.detach().new_empty((*p.shape[:-1], 1)) if rowwise else p.detach()
        for name, p in params.items()
    }
    moments = []
    for tree, expected in ((mu, expected_mu), (nu, expected_nu)):
        flat: Dict[Tuple[str, ...], np.ndarray] = {}
        _flatten(tree, (), flat)
        moments.append(_convert(flat, expected))
    return params, moments


def adamw_state_from_jax(mu: dict, nu: dict, count, module: nn.Module, optimizer) -> None:
    """Load optax ``ScaleByAdamState`` moments (``mu``, ``nu``: trees shaped
    like ``params``, masked entries dropped) and ``count`` into the state of
    ``optimizer`` (a ``torch.optim.AdamW`` over parameters of ``module``).
    Strict: every parameter the optimizer holds is filled, and every entry
    given fills one."""
    params, moments = _moments(mu, nu, module, optimizer, rowwise=False)
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    for name, p in params.items():
        optimizer.state[p] = {
            "step": step.clone(),
            "exp_avg": moments[0][name].to(p.device),
            "exp_avg_sq": moments[1][name].to(p.device),
        }


def rowwise_adam_state_from_jax(state: dict, module: nn.Module, optimizer) -> None:
    """Load ``rowwise_adam``'s state ``{"mu", "nu", "count"}`` (trees shaped
    like ``params``, masked entries dropped; ``nu`` (..., 1)) into
    ``optimizer`` (a ``RowwiseAdam`` over parameters of ``module``).
    Strict, as ``adamw_state_from_jax``."""
    params, moments = _moments(state["mu"], state["nu"], module, optimizer, rowwise=True)
    for name, p in params.items():
        optimizer.state[p] = {
            "step": torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32, device=p.device),
            "exp_avg": moments[0][name].to(p.device),
            "exp_avg_sq": moments[1][name].to(p.device),
        }


def table_state_from_jax(table_state, table: torch.Tensor):
    """The JAX ``FusedTableState`` or ``LazyRowState`` (as numpy arrays)
    -> the port's, on ``table``'s device; shapes checked against the table."""
    from recommendations_tpu_torch.train.sparse_table import FusedTableState, LazyRowState

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=table.device)

    count = t(table_state.count, torch.int32)
    if count.shape != ():
        raise ValueError(f"table state count: expected a scalar, got {tuple(count.shape)}")
    if not hasattr(table_state, "m"):
        return FusedTableState(count=count)
    m, v = t(table_state.m, torch.float32), t(table_state.v, torch.float32)
    if m.shape != table.shape or v.shape != (table.shape[0], 1):
        raise ValueError(f"lazy table state: m {tuple(m.shape)}, v {tuple(v.shape)} for a table {tuple(table.shape)}")
    return LazyRowState(m=m, v=v, count=count)


def aux_state_from_jax(aux, device=None):
    """The JAX ``LTHMAuxState`` (as numpy arrays, e.g. through
    ``jax.tree_util.tree_map(np.asarray, aux)``) -> the port's."""
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMAuxState
    from recommendations_tpu_torch.nn.logq import LogQState

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    lq = aux.logq
    return LTHMAuxState(
        logq=LogQState(
            b=t(lq.b, torch.float32), a=t(lq.a, torch.float32),
            hash_offsets=t(lq.hash_offsets, torch.int64),
        ),
        batch_idx=t(aux.batch_idx, torch.float32),
    )
