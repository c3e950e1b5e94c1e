"""Train state threaded through the training step.

Port of ``recommendations_tpu/train/train_state.py``. The parameters live in
the wrapper's module and the optimizer moments in the optimizer, so the
state holds those two objects beside the model's aux state (the logQ
estimator), the step count, the generator that draws the lookahead
offsets (a CPU generator: the offsets are host integers) and the lazy or
fused table's update state (``train/sparse_table.py``; None on the other
table paths).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
from recommendations_tpu_torch.train.optimizers import TrainOptimizer, build_optimizer


@dataclass
class TrainState:
    wrapper: Any
    optimizer: TrainOptimizer
    aux: Any
    generator: torch.Generator
    step: int = 0
    table_state: Any = None

    @classmethod
    def create(
        cls, wrapper, train_config: Optional[ModelTrainConfig] = None, seed: int = 1
    ) -> "TrainState":
        return cls(
            wrapper=wrapper,
            optimizer=build_optimizer(wrapper, train_config or ModelTrainConfig()),
            aux=wrapper.init_aux_state(),
            generator=torch.Generator().manual_seed(seed),
            table_state=wrapper.init_table_state(),
        )
