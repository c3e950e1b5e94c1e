"""Trainer config: the fields of ``ModelTrainConfig`` the training step reads.

Port of part of ``recommendations_tpu/config/trainer_config.py`` (a pydantic
model there, a dataclass here), with the same names and defaults. The
reflection knobs (``optimizer_clazz``, ``lr_scheduler_clazz``), which name
optax objects, are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class ModelTrainConfig:
    learning_rate: float = 0.001
    weight_decay: Optional[float] = None
    gradient_clip_norm: Optional[float] = None
    gradient_clip_value: Optional[float] = None
    gradient_accumulation_steps: Optional[int] = None
