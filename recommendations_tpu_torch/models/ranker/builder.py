"""Ranker builder - port of ``recommendations_tpu/models/ranker/builder.py``:
the wrapper on ``device``, its weights drawn from ``seed``."""

from __future__ import annotations

from typing import Any, Optional

from recommendations_tpu_torch.models.ranker.config import RankerModelConfig
from recommendations_tpu_torch.models.ranker.wrapper import RankerModelWrapper
from recommendations_tpu_torch.pipeline.model_builder import ModelBuilder


class RankerModelBuilder(ModelBuilder):
    def __init__(self, stats: Optional[Any], model_config: RankerModelConfig, device="cuda", seed: int = 0):
        super().__init__(stats)
        self.model_config = model_config
        self.device = device
        self.seed = seed

    def build(self) -> RankerModelWrapper:
        return RankerModelWrapper(self.model_config, self.stats, device=self.device, seed=self.seed)
