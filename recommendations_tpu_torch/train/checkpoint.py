"""Full train-state checkpoints with resume, written in the background.

Port of ``recommendations_tpu/train/checkpoint.py``: Orbax becomes
``torch.save``. A checkpoint is the whole ``TrainState``
(``TrainState.state_dict``: the parameters, the optimizers' moments, the
aux state, the table state, the step and the offsets' generator) with the
data-iterator position and the step's metrics, one file a step,
``step_XXXXXXXX.pt``; the newest ``max_to_keep`` are kept. Each tensor is
loaded back onto the device it was saved from, so a checkpoint resumes on
the kind of device it was written on.

As Orbax's asynchronous checkpoints (``enable_async_checkpointing``),
``save`` copies the state to host memory on the calling thread and hands
the write (``torch.save`` to a temporary file, ``os.replace``, the pruning)
to a background thread, one write in flight: a second ``save`` first waits
for the one before. ``wait`` blocks until the write in flight is on disk,
``close`` also ends the manager; an error in the writer is raised again by
the next ``save``, ``wait`` or ``close``. The host copy keeps each storage
once (tensors that share one still share it) and is written under the
device tags of the tensors it copies, so the file is the one a synchronous
``torch.save`` of the state writes.
"""

from __future__ import annotations

import copy
import os
import re
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.serialization

_NAME = re.compile(r"^step_(\d+)\.pt$")

# the writer thread's map: host storage -> the device tag of the storage it copies
_WRITING = threading.local()
_TAGGER = threading.Lock()
_tagger_registered = False


def _device_tag(storage) -> Optional[str]:
    tags = getattr(_WRITING, "tags", None)
    return None if tags is None else tags.get(storage._cdata)


def _register_tagger() -> None:
    """Once a process, ahead of torch's own taggers (cpu is 10): a host copy
    is saved under its source's device tag."""
    global _tagger_registered
    with _TAGGER:
        if not _tagger_registered:
            torch.serialization.register_package(0, _device_tag, lambda obj, location: None)
            _tagger_registered = True


def _tensor_to_host(t: torch.Tensor, storages: dict, tags: Dict[int, str]) -> torch.Tensor:
    src = t.untyped_storage()
    if src.nbytes() == 0:
        return t
    host = storages.get(src._cdata)
    if host is None:
        host = src.clone() if src.device.type == "cpu" else src.cpu()
        storages[src._cdata] = host
        if src.device.type != "cpu":
            tags[host._cdata] = torch.serialization.location_tag(src)
    out = torch.empty(0, dtype=t.dtype).set_(host, t.storage_offset(), t.size(), t.stride())
    if isinstance(t, torch.nn.Parameter):
        return torch.nn.Parameter(out, requires_grad=t.requires_grad)
    return out.requires_grad_(t.requires_grad)


def host_copy(obj):
    """``obj`` with every tensor copied to host memory: dicts (their type
    and attributes kept, as a module's ``_metadata``), lists, tuples and
    named tuples rebuilt, anything else shared. Returns (the copy, each
    host storage's device tag where it is not the CPU)."""
    storages: dict = {}
    tags: Dict[int, str] = {}

    def walk(x):
        if torch.is_tensor(x):
            return _tensor_to_host(x, storages, tags)
        if isinstance(x, dict):
            out = copy.copy(x)
            for k, v in x.items():
                out[k] = walk(v)
            return out
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*map(walk, x))
        if isinstance(x, (list, tuple)):
            return type(x)(map(walk, x))
        return x

    return walk(obj), tags


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

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
        ``state.state_dict()``), copied to host memory here and written by
        the background thread (whole, before it replaces any file of that
        name; then the oldest files past ``max_to_keep`` go)."""
        self.wait()
        _register_tagger()
        payload, tags = host_copy({
            "state": state.state_dict() if state_dict is None else state_dict,
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
            "data_iter": dict(data_iter_state or {}),
        })
        self._writer = threading.Thread(target=self._write, args=(step, payload, tags),
                                        name=f"checkpoint-{step}", daemon=True)
        self._writer.start()

    def _write(self, step: int, payload: dict, tags: Dict[int, str]) -> None:
        try:
            _WRITING.tags = tags
            try:
                tmp = self.path(step) + f".{os.getpid()}.tmp"
                torch.save(payload, tmp)
            finally:
                _WRITING.tags = None
            os.replace(tmp, self.path(step))
            for old in self.steps()[: -self.max_to_keep]:
                os.remove(self.path(old))
        except Exception as e:  # raised again in the caller's thread
            self._error = e

    def wait(self) -> None:
        """Block until the write in flight is on disk; raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()

    def restore(self, state, step: Optional[int] = None, prepare=None) -> Optional[Tuple[object, dict]]:
        """Loads the checkpoint of ``step`` (the latest by default) into
        ``state``, through ``prepare`` where given (a rank's cut of a whole
        state): (state, data-iterator state), or None without one. A write
        in flight finishes first."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        # our own files: they hold the aux state's named tuples
        payload = torch.load(self.path(step), weights_only=False)
        state.load_state_dict(payload["state"] if prepare is None else prepare(payload["state"]))
        return state, payload["data_iter"]
