"""Train state threaded through the training step.

Port of ``recommendations_tpu/train/train_state.py``. The parameters live in
the wrapper's module and the optimizer moments in the optimizer, so the
state holds those two objects beside the model's aux state (the logQ
estimator), the step count, the two generators of the JAX state's ``rng``
(``generator`` draws the lookahead offsets, the loss's key;
``dropout_generator`` draws each step's dropout seed, the forward's key,
from which the step's masks are drawn on the device; both CPU generators:
their draws are host integers) and the lazy or fused table's update state
(``train/sparse_table.py``; None on the other table paths).
``state_dict`` and ``load_state_dict`` carry all of it, the optimizer's
gradient accumulation included, for ``train/checkpoint.py``. ``graph``
holds the step captured on a card (``train/step_graph.py``); it is no part
of the state, and ``load_state_dict`` drops it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
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
    dropout_generator: Optional[torch.Generator] = None
    graph: Any = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.dropout_generator is None:
            self.dropout_generator = torch.Generator().manual_seed(self.generator.initial_seed() + 1)

    def next_dropout_seed(self) -> int:
        """The step's dropout seed (one draw a step, as JAX splits its key)."""
        return int(torch.randint(0, 2**62, (), generator=self.dropout_generator))

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
        opt = self.optimizer.state_dict()
        return {
            "module": self.wrapper.module.state_dict(),
            "optimizers": opt.pop("optimizers"),
            "accumulation": opt,
            "aux": self.aux,
            "table_state": self.table_state,
            "step": self.step,
            "generator": self.generator.get_state(),
            "dropout_generator": self.dropout_generator.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        self.graph = None
        self.wrapper.module.load_state_dict(sd["module"])
        self.optimizer.load_state_dict({"optimizers": sd["optimizers"], **sd["accumulation"]})
        self.aux = sd["aux"]
        self.table_state = sd["table_state"]
        self.step = int(sd["step"])
        self.generator.set_state(sd["generator"])
        self.dropout_generator.set_state(sd["dropout_generator"])
