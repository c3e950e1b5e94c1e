"""Process start to the first timed step or request: imports, the pool and
the weights from the seed, the kernels' load (and build, in a fresh
checkout) and the warm-up on the cell's own shapes."""

from __future__ import annotations

UNIT = "s"
BETTER = "lower"
LAYER = ""
MOVES = ""
SOURCE = "host_clock"


def read(run):
    return run.setup_s
