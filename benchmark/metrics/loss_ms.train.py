"""Device time of the kernels launched in ``lthm/loss`` and ``lthm/ce_backward``,
per step."""

from __future__ import annotations

UNIT = "ms"
BETTER = "lower"
LAYER = "loss: models/lthm/loss.py, nn/logq.py, ops/fused_ce.py"
MOVES = "train_examples_per_s"
SOURCE = "device_trace"


PHASES = ("lthm/loss", "lthm/ce_backward")


def read(run):
    if run.trace is None or not run.trace.device_us(PHASES):
        return None
    return run.trace.device_us(PHASES) / run.trace.units / 1e3
