"""Model FLOPs of a step of LTHM with the LFM2 backbone from its shapes
(``arith.lthm_lfm2.train_flops``) over the window's mean step time, against
one H100's dense bf16 peak; the card's power limit is printed beside it."""

from __future__ import annotations

from benchmark.arith.bounds import PEAKS
from benchmark.arith.lthm_lfm2 import train_flops

UNIT = "%"
BETTER = "higher"
LAYER = "whole step"
MOVES = "train_examples_per_s"
SOURCE = "host_clock"


def read(run):
    if not run.extra.get("on_chip"):
        return None
    per_unit_s = run.window_s / run.units
    return 100.0 * train_flops(run.shapes) / per_unit_s / PEAKS["bf16_flops_per_s"]
