"""Host time from the call into models/lthm/wrapper.py (user_encoder) to its return, the mean over
the window's calls."""

from __future__ import annotations

UNIT = "ms"
BETTER = "lower"
LAYER = "entry: train/step.py, models/lthm/wrapper.py"
MOVES = "serve_users_per_s"
SOURCE = "host_clock"


def read(run):
    return 1e3 * sum(run.dispatch_s) / len(run.dispatch_s) if run.dispatch_s else None
