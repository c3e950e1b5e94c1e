"""Training-strategy configs and their registry.

Port of ``recommendations_tpu/config/training_strategy_config.py``. Both
names the JAX package registers are kept: ``pjit`` (which both training
YAMLs set) and ``single_device``. In the port both run the single-process
strategy (``train/strategy.py``) on one device; the fields of a mesh, of
multi-host runs, of profile capture and of the sanitizer mode are kept for
the config's shape, and the strategy refuses the values it cannot honour.
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
    """A mesh-parallel jit strategy in the JAX package; one device here."""

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
