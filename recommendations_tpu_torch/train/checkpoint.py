"""Full train-state checkpoints with resume.

Port of ``recommendations_tpu/train/checkpoint.py``: Orbax becomes
``torch.save``. A checkpoint is the whole ``TrainState``
(``TrainState.state_dict``: the parameters, the optimizers' moments, the
aux state, the table state, the step and the offsets' generator) with the
data-iterator position and the step's metrics, one file a step,
``step_XXXXXXXX.pt``; the newest ``max_to_keep`` are kept. Each tensor is
loaded back onto the device it was saved from, so a checkpoint resumes on
the kind of device it was written on.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, metrics: Optional[dict] = None, data_iter_state: Optional[dict] = None,
             state_dict: Optional[dict] = None) -> None:
        """The state after ``step`` steps (``state_dict``, else
        ``state.state_dict()``), written whole before it replaces any file
        of that name; then the oldest files past ``max_to_keep`` go."""
        payload = {
            "state": state.state_dict() if state_dict is None else state_dict,
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            "data_iter": dict(data_iter_state or {}),
        }
        tmp = self.path(step) + f".{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, state, step: Optional[int] = None, prepare=None) -> Optional[Tuple[object, dict]]:
        """Loads the checkpoint of ``step`` (the latest by default) into
        ``state``, through ``prepare`` where given (a rank's cut of a whole
        state): (state, data-iterator state), or None without one."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        # our own files: they hold the aux state's named tuples
        payload = torch.load(self.path(step), weights_only=False)
        state.load_state_dict(payload["state"] if prepare is None else prepare(payload["state"]))
        return state, payload["data_iter"]
