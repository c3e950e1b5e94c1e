"""LTHM builder - port of ``recommendations_tpu/models/lthm/builder.py``:
the wrapper on ``device``, its weights drawn from ``seed``."""

from __future__ import annotations

from typing import Any, Optional

from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.pipeline.model_builder import ModelBuilder


class LTHMModelBuilder(ModelBuilder):
    def __init__(self, stats: Optional[Any], model_config: LTHMModelConfig, device="cuda", seed: int = 0):
        super().__init__(stats)
        self.model_config = model_config
        self.device = device
        self.seed = seed

    def build(self) -> LTHMModelWrapper:
        return LTHMModelWrapper(self.model_config, device=self.device, seed=self.seed)
