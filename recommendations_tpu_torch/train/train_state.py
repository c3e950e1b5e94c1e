"""Train state threaded through the training step.

Port of ``recommendations_tpu/train/train_state.py``. The parameters live in
the wrapper's module and the optimizer moments in the optimizer, so the
state holds those two objects beside the model's aux state (the logQ
estimator), the step count, the generator that draws the lookahead
offsets (a CPU generator: the offsets are host integers) and the lazy or
fused table's update state (``train/sparse_table.py``; None on the other
table paths). ``state_dict`` and ``load_state_dict`` carry all of it for
``train/checkpoint.py``.
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

    def state_dict(self) -> dict:
        return {
            "module": self.wrapper.module.state_dict(),
            "optimizers": [opt.state_dict() for opt in self.optimizer.optimizers()],
            "aux": self.aux,
            "table_state": self.table_state,
            "step": self.step,
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        self.wrapper.module.load_state_dict(sd["module"])
        optimizers = self.optimizer.optimizers()
        if len(optimizers) != len(sd["optimizers"]):
            raise ValueError(f"{len(sd['optimizers'])} optimizer states for {len(optimizers)} optimizers")
        for opt, opt_sd in zip(optimizers, sd["optimizers"]):
            opt.load_state_dict(opt_sd)
        self.aux = sd["aux"]
        self.table_state = sd["table_state"]
        self.step = int(sd["step"])
        self.generator.set_state(sd["generator"])
