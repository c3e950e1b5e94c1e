"""Device time of the kernels launched in ``lthm/short_conv`` (the gated
short convolutions' forward: ``in_proj``, the gates and the depthwise
taps, ``out_proj``; opened again in remat's rerun), per step. Their
backward is ``lthm/backward``'s. None when the range is absent."""

from __future__ import annotations

UNIT = "ms"
BETTER = "lower"
LAYER = "towers: models/lthm/model.py, nn/"
MOVES = "train_examples_per_s"
SOURCE = "device_trace"


PHASES = ("lthm/short_conv",)


def read(run):
    if run.trace is None or not run.trace.device_us(PHASES):
        return None
    return run.trace.device_us(PHASES) / run.trace.units / 1e3
