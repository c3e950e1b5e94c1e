"""Console and JSONL trackers.

Port of ``recommendations_tpu/trackers/console.py``: the same events, keys
and record layout (``{"event", ..., "ts"}`` one JSON object a line).
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

from recommendations_tpu_torch.trackers.base import Tracker, register_tracker

logger = logging.getLogger(__name__)


@register_tracker
@dataclass
class ConsoleTracker(Tracker):
    kind: str = "console"

    def start_run(self, run_id=None, experiment=None) -> None:
        logger.info("start_run run_id=%s experiment=%s", run_id, experiment)

    def end_run(self, error: bool = False) -> None:
        logger.info("end_run status=%s", "FAILED" if error else "FINISHED")

    def log_params(self, params: Dict[str, Any]) -> None:
        logger.info("params: %s", params)

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        compact = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in metrics.items()}
        logger.info("step=%s metrics=%s", step, compact)


@register_tracker
@dataclass
class JsonlTracker(Tracker):
    """Append-only metrics log."""

    kind: str = "jsonl"
    path: str = "metrics.jsonl"

    def _write(self, record: Dict[str, Any]) -> None:
        record["ts"] = time.time()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")

    def start_run(self, run_id=None, experiment=None) -> None:
        self._write({"event": "start_run", "run_id": run_id, "experiment": experiment})

    def end_run(self, error: bool = False) -> None:
        self._write({"event": "end_run", "error": error})

    def log_params(self, params: Dict[str, Any]) -> None:
        self._write({"event": "params", "params": {k: str(v) for k, v in params.items()}})

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        self._write({"event": "metrics", "step": step, "metrics": metrics})
