"""Device time of the kernels launched in ``lthm/optimizer``, per step."""

from __future__ import annotations

UNIT = "ms"
BETTER = "lower"
LAYER = "optimizer: train/optimizers.py"
MOVES = "train_examples_per_s"
SOURCE = "device_trace"


PHASES = ("lthm/optimizer",)


def read(run):
    if run.trace is None or not run.trace.device_us(PHASES):
        return None
    return run.trace.device_us(PHASES) / run.trace.units / 1e3
