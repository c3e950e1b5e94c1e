"""Tracker base class and registry.

Port of ``recommendations_tpu/trackers/base.py`` (reference
``commons/trackers/base.py:16-58``): a tracker is a dataclass with a
``kind``; keys a YAML gives beyond its fields are kept, as the JAX
package's trackers allow extra keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

trackers_registry: Dict[str, type] = {}


def register_tracker(cls):
    trackers_registry[cls.__dataclass_fields__["kind"].default] = cls
    return cls


@dataclass
class Tracker:
    kind: str
    extra = "allow"

    def start_run(self, run_id: Optional[str] = None, experiment: Optional[str] = None) -> None:
        pass

    def end_run(self, error: bool = False) -> None:
        pass

    def log_params(self, params: Dict[str, Any]) -> None:
        pass

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        pass

    def log_artifacts(self, local_dir: str) -> None:
        pass

    def watch(self, model: Any, log_graph: bool = False) -> None:
        pass
