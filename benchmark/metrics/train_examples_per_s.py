"""Every example of the window over the window's wall time; the window ends
in a synchronize."""

from __future__ import annotations

UNIT = "examples/s"
BETTER = "higher"
LAYER = ""
MOVES = ""
SOURCE = "host_clock"


def read(run):
    return run.units * run.users_per_unit / run.window_s
