"""Model export: the weights, the model config and the traced inference
programs.

Port of ``recommendations_tpu/pipeline/export.py``:
- ``params/state_dict.pt``: ``torch.save`` of the module's state dict (the
  weights and the LSH projections), on the host;
- ``config.json``: the model config as the JAX package writes it
  (pydantic's ``model_dump_json(indent=2)``);
- ``<name>.pt2``, given a trace batch: ``torch.export`` of each entry of
  ``wrapper.inference_models()``, the counterpart of ``<name>.stablehlo``.
  As ``jax.export`` fixes them, the shapes are static (the trace batch's)
  and the program takes ``(variables, batch)``: the state dict of
  ``params/`` and the batch's numeric columns. The flash-attention kernels
  stay operators of the program (``ops/fused_attention.py``), so the loaded
  program launches them on the card; loading needs only ``torch`` and
  ``recommendations_tpu_torch.ops``, which registers them.

``load_exported_wrapper`` builds a serving wrapper from the first two files,
of the model the config's ``kind`` names; ``load_inference_program`` loads
one traced program with the weights it runs on.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from recommendations_tpu_torch.config.base import model_dump, to_json_value

logger = logging.getLogger(__name__)

PARAMS = os.path.join("params", "state_dict.pt")
PROGRAM_SUFFIX = ".pt2"


def program_inputs(batch: Mapping[str, object], device) -> Dict[str, torch.Tensor]:
    """The columns a traced program takes: every numeric column but
    ``_pad_mask``, as tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        if k == "_pad_mask":
            continue
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        elif getattr(v, "dtype", None) is not None and np.asarray(v).dtype.kind in "ifub":
            out[k] = torch.as_tensor(np.asarray(v)).to(device)
    return out


class _Entry(torch.nn.Module):
    """An inference entry point over the wrapper's module, so that
    ``functional_call`` can swap the module's state for the program's
    inputs."""

    def __init__(self, module: torch.nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, batch):
        return self.fn(batch)


class _Program(torch.nn.Module):
    """(variables, batch) -> the entry point's outputs. The entry is held
    outside the module tree, so the program carries no weights of its own:
    they are its first input, as ``jax.export``'s variables are."""

    def __init__(self, entry: _Entry):
        super().__init__()
        self.__dict__["entry"] = entry

    def forward(self, variables: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
        state = {f"module.{k}": v for k, v in variables.items()}
        return torch.func.functional_call(self.entry, state, (batch,))


def export_programs(wrapper, directory: str, trace_batch: Mapping[str, object]) -> None:
    """``<name>.pt2`` for each inference entry point, traced on
    ``trace_batch``. A program that fails to trace is logged and left out,
    as the JAX package does."""
    variables = {k: v.detach() for k, v in wrapper.module.state_dict().items()}
    batch = program_inputs(trace_batch, wrapper.device)
    for name, fn in wrapper.inference_models().items():
        try:
            program = torch.export.export(_Program(_Entry(wrapper.module, fn)), (variables, batch), strict=False)
            # the trace inputs hold the weights: the program keeps neither
            program.example_inputs = None
            path = os.path.join(directory, f"{name}{PROGRAM_SUFFIX}")
            torch.export.save(program, path)
            logger.info("exported %s (%d bytes)", path, os.path.getsize(path))
        except Exception:
            logger.exception("torch.export failed for %s", name)


def export_model_artifacts(wrapper, directory: str, export_config_str: bool = True,
                           trace_batch: Optional[Mapping[str, object]] = None) -> None:
    """The weights (``wrapper.export_weights`` where the training strategy
    set them: a model laid over a mesh, its sharded parameters gathered,
    whose forward one rank cannot trace alone), the config and the traced
    programs."""
    os.makedirs(os.path.join(directory, "params"), exist_ok=True)
    gathered = getattr(wrapper, "export_weights", None)
    state = wrapper.module.state_dict() if gathered is None else gathered
    weights = {k: v.detach().cpu() for k, v in state.items()}
    torch.save(weights, os.path.join(directory, PARAMS))
    if export_config_str:
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(to_json_value(model_dump(wrapper.config)), f, indent=2)
    if trace_batch is not None and gathered is None:
        export_programs(wrapper, directory, trace_batch)


def load_exported_wrapper(directory: str, device="cuda"):
    """A fresh wrapper (LTHM or ranker, by the config's ``kind`` and
    ``name``) from an export's ``config.json`` and weights."""
    from recommendations_tpu_torch.config.model_config import resolve_model_config

    with open(os.path.join(directory, "config.json")) as f:
        d = json.load(f)
    config = resolve_model_config(str(d.get("kind", "")), str(d.get("name", ""))).from_dict(d)
    wrapper = config.get_builder(device=device).build()
    wrapper.module.load_state_dict(torch.load(os.path.join(directory, PARAMS), map_location=wrapper.device))
    return wrapper


def load_inference_program(directory: str, name: str, device="cuda") -> Callable:
    """The traced entry point ``name`` of an export, on the weights of its
    ``params/``: a function of a batch (numeric columns at the trace
    batch's shapes), without the model's Python."""
    from recommendations_tpu_torch import resolve_device

    device = resolve_device(device)
    program = torch.export.load(os.path.join(directory, f"{name}{PROGRAM_SUFFIX}")).module()
    variables = torch.load(os.path.join(directory, PARAMS), map_location=device)

    def run(batch: Mapping[str, object]):
        with torch.no_grad():
            return program(variables, program_inputs(batch, device))

    return run
