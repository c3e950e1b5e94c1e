"""Training-strategy configs and their registry.

Port of ``recommendations_tpu/config/training_strategy_config.py``. Both
names the JAX package registers are kept: ``pjit`` (which both training
YAMLs set) and ``single_device``. In the port both run the strategy of
``train/strategy.py``: on one device, or over the ``mesh_*`` fields' mesh of
the ranks ``torchrun`` starts (``core/mesh.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

training_strategy_registry: Dict[str, type] = {}


def _registered(cls):
    training_strategy_registry[cls.__dataclass_fields__["name"].default] = cls
    return cls


@dataclass
class TrainingStrategyConfig:
    name: str
    extra = "allow"


@_registered
@dataclass
class PjitTrainingStrategyConfig(TrainingStrategyConfig):
    """The mesh-parallel strategy (a mesh of ranks here)."""

    name: str = "pjit"
    precision: str = "bf16"
    mesh_data: int = -1
    mesh_model: int = 1
    mesh_expert: int = 1
    mesh_dcn_data: Optional[int] = None
    donate_state: bool = True
    timeout: int = 300
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_num_steps: int = 5
    debug_numerics: bool = False


@_registered
@dataclass
class SingleDeviceTrainingStrategyConfig(TrainingStrategyConfig):
    name: str = "single_device"
    precision: str = "bf16"
