"""Host time from the call into train/step.py (train_step) to its return, the mean over
the window's calls."""

from __future__ import annotations

UNIT = "ms"
BETTER = "lower"
LAYER = "entry: train/step.py, models/lthm/wrapper.py"
MOVES = "train_examples_per_s"
SOURCE = "host_clock"


def read(run):
    return 1e3 * sum(run.dispatch_s) / len(run.dispatch_s) if run.dispatch_s else None
