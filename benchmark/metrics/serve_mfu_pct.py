"""Model FLOPs of a request from its shapes (``arith.lthm.serve_flops``) over the
window's mean request time, against one H100's dense bf16 peak; the card's
power limit is printed beside it."""

from __future__ import annotations

from benchmark.arith.bounds import PEAKS
from benchmark.arith.lthm import serve_flops

UNIT = "%"
BETTER = "higher"
LAYER = "whole request"
MOVES = "serve_users_per_s"
SOURCE = "host_clock"


def read(run):
    if not run.extra.get("on_chip"):
        return None
    per_unit_s = run.window_s / run.units
    return 100.0 * serve_flops(run.shapes) / per_unit_s / PEAKS["bf16_flops_per_s"]
