"""The root pipeline config.

Port of ``recommendations_tpu/config/pipeline_config.py``: the ``model``
section dispatches on (kind, name) through ``model_registry``,
``training_strategy`` on its name through ``training_strategy_registry``,
and ``trackers`` through the tracker registry; ``model_version`` and
``run_id`` are made when absent; a ``stats`` section becomes a
``pipeline.stats.StatsConfig``. Unknown top-level keys (``datestr``) are
ignored, as pydantic ignores them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

from recommendations_tpu_torch.config.base import build_fields
from recommendations_tpu_torch.config.model_config import ModelConfig, resolve_model_config
from recommendations_tpu_torch.config.trainer_config import (
    DataLoaderConfig,
    ModelEvalConfig,
    ModelExportConfig,
    ModelInferenceConfig,
    ModelTrainConfig,
    TrainDatasetConfig,
)
from recommendations_tpu_torch.config.training_strategy_config import (
    PjitTrainingStrategyConfig,
    TrainingStrategyConfig,
    training_strategy_registry,
)
from recommendations_tpu_torch.trackers.facade import TrainingTrackersConfig


@dataclass
class TrainerPipelineConfig:
    model: ModelConfig
    dataset: TrainDatasetConfig
    platform: str = "tpu"
    model_version: Optional[str] = None
    run_id: Optional[str] = None
    log_verbosity: int = 1
    checkpoint_dir: Optional[str] = None
    train: ModelTrainConfig = field(default_factory=ModelTrainConfig)
    eval: Optional[ModelEvalConfig] = field(default_factory=ModelEvalConfig)
    inference: ModelInferenceConfig = field(default_factory=ModelInferenceConfig)
    export: Optional[ModelExportConfig] = None
    data_loader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    training_strategy: TrainingStrategyConfig = field(default_factory=PjitTrainingStrategyConfig)
    trackers: Any = None
    stats: Any = None

    @classmethod
    def from_dict(cls, d: dict) -> "TrainerPipelineConfig":
        d = dict(d)
        model = d.get("model")
        if isinstance(model, dict):
            d["model"] = resolve_model_config(str(model.get("kind", "")), str(model.get("name", ""))).from_dict(model)
        ts = d.get("training_strategy")
        if isinstance(ts, dict):
            name = ts.get("name", "pjit")
            ts_cls = training_strategy_registry.get(name)
            if ts_cls is None:
                raise KeyError(f"Unknown training strategy '{name}'; known: {sorted(training_strategy_registry)}")
            d["training_strategy"] = build_fields(ts_cls, ts)
        st = d.get("stats")
        if isinstance(st, dict):
            from recommendations_tpu_torch.pipeline.stats import StatsConfig

            if isinstance(st.get("data_loader"), dict):
                st = dict(st, data_loader=build_fields(DataLoaderConfig, st["data_loader"]))
            d["stats"] = build_fields(StatsConfig, st)
        trackers = d.get("trackers")
        if trackers is None or isinstance(trackers, dict):
            d["trackers"] = TrainingTrackersConfig.from_dict(trackers or {})
        if not d.get("model_version"):
            d["model_version"] = str(int(time.time()))
        if not d.get("run_id"):
            d["run_id"] = f"run_{d['model_version']}"
        return build_fields(cls, d)
