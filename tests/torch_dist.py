"""Launch the port's gloo workers for the multi-device parity tests.

``start_workers(cases, world)`` writes the cases (name, function of
``tests/torch_dist_worker.py``, keyword arguments of numpy arrays and plain
values) to a job file and starts ``world`` processes of that script, one
rank each, joined by a gloo group on a free localhost port; ``.results()``
waits for them (killing all at the time limit, so a hung collective fails
its test instead of the suite) and returns each rank's results by case
name. The workers import only the port, torch and numpy; the test file
computes the JAX side while they run.
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_worker.py")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Workers:
    def __init__(self, cases: Sequence[Tuple[str, str, dict]], world: int, timeout: float):
        self.dir = tempfile.mkdtemp(prefix="torch_dist_")
        self.job = os.path.join(self.dir, "job.pkl")
        with open(self.job, "wb") as f:
            pickle.dump(list(cases), f)
        self.world, self.timeout, self.start = world, timeout, time.monotonic()
        port = free_port()
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.logs = [open(os.path.join(self.dir, f"rank{r}.log"), "wb") for r in range(world)]
        self.procs = [
            subprocess.Popen(
                [sys.executable, WORKER, self.job, str(r), str(world), str(port)],
                env=env, cwd=REPO, stdout=self.logs[r], stderr=subprocess.STDOUT,
            )
            for r in range(world)
        ]

    def _log(self, r: int) -> str:
        self.logs[r].flush()
        with open(os.path.join(self.dir, f"rank{r}.log"), "rb") as f:
            return f.read().decode(errors="replace")[-4000:]

    def results(self) -> List[Dict[str, object]]:
        """Each rank's results by case name; raises on a failed or hung rank."""
        try:
            for r, p in enumerate(self.procs):
                left = self.timeout - (time.monotonic() - self.start)
                try:
                    p.wait(timeout=max(left, 0.1))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"rank {r} still running after {self.timeout} s:\n{self._log(r)}")
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} exited {p.returncode}:\n{self._log(r)}")
            out = []
            for r in range(self.world):
                with open(f"{self.job}.rank{r}", "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in self.logs:
                f.close()
            shutil.rmtree(self.dir, ignore_errors=True)


def start_workers(cases, world: int, timeout: float = 120.0) -> Workers:
    return Workers(cases, world, timeout)
