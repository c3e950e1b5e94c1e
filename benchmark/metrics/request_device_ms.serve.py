"""Device time of every kernel and copy of a request (the call to the
synchronize), per request of the profiled sub-window."""

from __future__ import annotations

UNIT = "ms"
BETTER = "lower"
LAYER = "towers: models/lthm/model.py, nn/"
MOVES = "serve_users_per_s"
SOURCE = "device_trace"


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    return run.trace.device_us() / run.trace.units / 1e3
