"""Device time of the kernels launched in the routed MoE's ranges
(``lthm/moe_route``, ``lthm/moe_experts``, ``lthm/moe_combine``, opened
again in remat's rerun, and the backward's ``lthm/moe_backward`` and
``lthm/moe_experts_backward``), per step. None when no range is there."""

from __future__ import annotations

UNIT = "ms"
BETTER = "lower"
LAYER = "towers: models/lthm/model.py, nn/"
MOVES = "train_examples_per_s"
SOURCE = "device_trace"


PHASES = ("lthm/moe_route", "lthm/moe_experts", "lthm/moe_combine", "lthm/moe_backward",
          "lthm/moe_experts_backward")


def read(run):
    if run.trace is None or not run.trace.device_us(PHASES):
        return None
    return run.trace.device_us(PHASES) / run.trace.units / 1e3
