"""Model export: the weights and the model config.

Port of the first two parts of ``recommendations_tpu/pipeline/export.py``
(``:33-50``):
- ``params/state_dict.pt``: ``torch.save`` of the module's state dict (the
  weights and the LSH projections), on the host;
- ``config.json``: the model config as the JAX package writes it
  (pydantic's ``model_dump_json(indent=2)``).

The traced inference programs (StableHLO in the JAX package) are not ported
yet (ROADMAP, port queue item 11); ``load_exported_wrapper`` builds a
serving wrapper from the two files, of the model the config's ``kind``
names.
"""

from __future__ import annotations

import json
import os

import torch

from recommendations_tpu_torch.config.base import model_dump, to_json_value

PARAMS = os.path.join("params", "state_dict.pt")


def export_model_artifacts(wrapper, directory: str, export_config_str: bool = True) -> None:
    os.makedirs(os.path.join(directory, "params"), exist_ok=True)
    weights = {k: v.detach().cpu() for k, v in wrapper.module.state_dict().items()}
    torch.save(weights, os.path.join(directory, PARAMS))
    if export_config_str:
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(to_json_value(model_dump(wrapper.config)), f, indent=2)


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
