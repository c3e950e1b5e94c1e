"""Device time of the kernels launched in ``lthm/attention`` (an attention
layer's forward: the projections, the bias kernel or ``_sdpa``,
``out_proj``), per request. None when the range is absent."""

from __future__ import annotations

UNIT = "ms"
BETTER = "lower"
LAYER = "towers: models/lthm/model.py, nn/"
MOVES = "serve_users_per_s"
SOURCE = "device_trace"


PHASES = ('lthm/attention',)


def read(run):
    if run.trace is None or not run.trace.device_us(PHASES):
        return None
    return run.trace.device_us(PHASES) / run.trace.units / 1e3
