"""The routed experts' grouped products at one H100's dense bf16 peak
(``arith.lthm_lfm2.expert_executed_flops``: the forward, remat's rerun and
the backward's two products, over 989 TFLOP/s) over the device time of
every kernel launched in ``lthm/moe_experts`` and
``lthm/moe_experts_backward`` (found by range, not by name; their SwiGLU's
elementwise kernels included), per step. None when the ranges are
absent."""

from __future__ import annotations

from benchmark.arith.bounds import PEAKS
from benchmark.arith.lthm_lfm2 import expert_executed_flops

UNIT = "%"
BETTER = "higher"
LAYER = "towers: models/lthm/model.py, nn/"
MOVES = "train_examples_per_s"
SOURCE = "device_trace"


PHASES = ("lthm/moe_experts", "lthm/moe_experts_backward")


def read(run):
    if run.trace is None or not run.trace.device_us(PHASES):
        return None
    per_step_s = run.trace.device_us(PHASES) / run.trace.units / 1e6
    return 100.0 * expert_executed_flops(run.shapes) / PEAKS["bf16_flops_per_s"] / per_step_s
