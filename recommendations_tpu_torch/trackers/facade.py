"""Fan-out tracker facade, each tracker's failures kept from the run.

Port of ``recommendations_tpu/trackers/facade.py`` (reference
``commons/configs/tracker_config.py:18-88``). The ``mlflow`` kind's module
(``trackers/mlflow_tracker.py``) is imported when a config names it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from recommendations_tpu_torch.config.base import build_fields
from recommendations_tpu_torch.trackers import console as _console  # noqa: F401  (registers)
from recommendations_tpu_torch.trackers.base import Tracker, trackers_registry

logger = logging.getLogger(__name__)


def _flatten(prefix: str, d: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(key, v))
        else:
            out[key] = v
    return out


@dataclass
class TrainingTrackersConfig:
    experiment: Optional[str] = None
    run_id: Optional[str] = None
    trackers: List[Tracker] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainingTrackersConfig":
        d = dict(d)
        built = []
        for t in d.get("trackers") or []:
            if isinstance(t, dict):
                kind = t.get("kind", "")
                if kind == "mlflow" and kind not in trackers_registry:
                    from recommendations_tpu_torch.trackers import mlflow_tracker  # noqa: F401  (registers)
                tcls = trackers_registry.get(kind)
                if tcls is None:
                    raise KeyError(f"Unknown tracker kind {kind!r}")
                t = build_fields(tcls, t)
            built.append(t)
        d["trackers"] = built or [trackers_registry["console"]()]
        return build_fields(cls, d)

    def _each(self, method: str, *args, **kw) -> None:
        for t in self.trackers:
            try:
                getattr(t, method)(*args, **kw)
            except Exception:  # one failing tracker never stops the run
                logger.exception("tracker %s.%s failed", type(t).__name__, method)

    def start_run(self) -> None:
        self._each("start_run", run_id=self.run_id, experiment=self.experiment)

    def end_run(self, error: bool = False) -> None:
        self._each("end_run", error=error)

    def log_params(self, params: Dict[str, Any]) -> None:
        self._each("log_params", params)

    def log_params_flatten(self, prefix: str, params: Dict[str, Any]) -> None:
        self._each("log_params", _flatten(prefix, params))

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        self._each("log_metrics", metrics, step=step)

    def log_artifacts(self, local_dir: str) -> None:
        self._each("log_artifacts", local_dir)

    def watch(self, model: Any, log_graph: bool = False) -> None:
        self._each("watch", model, log_graph=log_graph)
