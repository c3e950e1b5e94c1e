"""The model config's registry, keyed on (kind, name), and its data hooks.

Port of ``recommendations_tpu/config/model_config.py``. A model config
class enters ``model_registry`` through ``register_model_config``, under the
defaults of its ``kind`` and ``name`` fields; the lookup tries the YAML's
(kind, name) and then falls back to a match on the kind alone.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

from recommendations_tpu_torch.features.transforms import Table


model_registry: Dict[str, type] = {}

_MODEL_PACKAGES = (
    "recommendations_tpu_torch.models.lthm.config",
    "recommendations_tpu_torch.models.ranker.config",
)


def register_model_config(cls):
    fields = cls.__dataclass_fields__
    model_registry[f"{fields['kind'].default}/{fields['name'].default}"] = cls
    return cls


def resolve_model_config(kind: str, name: str) -> type:
    key = f"{kind}/{name}"
    if key not in model_registry:
        for pkg in _MODEL_PACKAGES:
            importlib.import_module(pkg)
    if key in model_registry:
        return model_registry[key]
    matches = [v for k, v in model_registry.items() if k.startswith(f"{kind}/")]
    if len(matches) == 1:
        return matches[0]
    raise KeyError(f"No model config registered for {key}; known: {sorted(model_registry)}")


class ModelConfig:
    """What every model config offers beside its fields: the data hooks
    (reference ``model_config.py:44-48``) and its builder."""

    def custom_data_preprocessor(self, table: Table, kind: str = "train") -> Table:
        return table

    def special_data_prepreprocessor(self, table: Table, kind: str = "train") -> Table:
        return table

    def preprocess_fn(self, kind: str = "train"):
        """Pre-hook, then the feature transforms, then the post-hook, per file."""

        def _fn(table: Table) -> Table:
            table = self.special_data_prepreprocessor(table, kind)
            table = self.features.default_data_mapper(table)
            table = self.custom_data_preprocessor(table, kind)
            return table

        return _fn

    def get_builder(self, stats: Any = None, device="cuda"):
        raise NotImplementedError
