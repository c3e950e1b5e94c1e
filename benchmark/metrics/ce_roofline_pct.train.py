"""The contrastive CE's least time (``arith.bounds.ce_s`` over the step's
calls at the cell's N) over the loss layer's device time per step: read
from the spans, so it reads the same work whether the eager CE or the CE
kernels do it."""

from __future__ import annotations

from benchmark.arith.lthm import ce_bound_s

UNIT = "%"
BETTER = "higher"
LAYER = "loss: models/lthm/loss.py, nn/logq.py, ops/fused_ce.py"
MOVES = "train_examples_per_s"
SOURCE = "device_trace"


PHASES = ("lthm/loss", "lthm/ce_backward")


def read(run):
    if run.trace is None or not run.trace.device_us(PHASES):
        return None
    per_step_s = run.trace.device_us(PHASES) / run.trace.units / 1e6
    return 100.0 * ce_bound_s(run.shapes) / per_step_s
