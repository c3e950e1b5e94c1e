"""The MLflow tracker.

Port of ``recommendations_tpu/trackers/mlflow_tracker.py`` (reference
``commons/trackers/mlflow_tracker.py:19-93``): the experiment by name (made
when missing), the run resumed by its id or else started under that name,
each parameter logged alone (a failing one skipped), the numeric metrics,
the artifacts, and the run's end as ``FAILED`` or ``FINISHED``. mlflow is
not a dependency: without it every call is a no-op, and ``start_run`` logs
a warning.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional

from recommendations_tpu_torch.trackers.base import Tracker, register_tracker

logger = logging.getLogger(__name__)

try:
    import mlflow  # type: ignore

    _HAVE_MLFLOW = True
except ImportError:
    mlflow = None
    _HAVE_MLFLOW = False


@register_tracker
@dataclass
class MlflowTracker(Tracker):
    kind: str = "mlflow"
    tracking_uri: Optional[str] = None
    experiment_name: str = "default"

    def start_run(self, run_id: Optional[str] = None, experiment: Optional[str] = None) -> None:
        if not _HAVE_MLFLOW:
            logger.warning("mlflow not installed; MlflowTracker is a no-op")
            return
        if self.tracking_uri:
            mlflow.set_tracking_uri(self.tracking_uri)
        name = experiment or self.experiment_name
        exp = mlflow.get_experiment_by_name(name)
        exp_id = exp.experiment_id if exp else mlflow.create_experiment(name)
        try:  # resume the run of that id (reference mlflow_tracker.py:41-55)
            mlflow.start_run(run_id=run_id, experiment_id=exp_id)
        except Exception:
            mlflow.start_run(experiment_id=exp_id, run_name=run_id)

    def end_run(self, error: bool = False) -> None:
        if _HAVE_MLFLOW:
            mlflow.end_run(status="FAILED" if error else "FINISHED")

    def log_params(self, params: Dict[str, Any]) -> None:
        if not _HAVE_MLFLOW:
            return
        for k, v in params.items():
            try:
                mlflow.log_param(k, v)
            except Exception:
                pass

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        if _HAVE_MLFLOW:
            mlflow.log_metrics({k: float(v) for k, v in metrics.items() if _is_number(v)}, step=step)

    def log_artifacts(self, local_dir: str) -> None:
        if _HAVE_MLFLOW:
            mlflow.log_artifacts(local_dir)


def _is_number(v: Any) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False
