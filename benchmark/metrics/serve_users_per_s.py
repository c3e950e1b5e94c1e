"""Every user served in the window over the window's wall time."""

from __future__ import annotations

UNIT = "users/s"
BETTER = "higher"
LAYER = ""
MOVES = ""
SOURCE = "host_clock"


def read(run):
    return run.units * run.users_per_unit / run.window_s
