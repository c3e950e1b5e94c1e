"""Device time of the kernels launched in ``lthm/mlp`` (a block's ``c_fc``,
GELU and ``c_proj``, or the MoE pair), per request. None when the range is
absent."""

from __future__ import annotations

UNIT = "ms"
BETTER = "lower"
LAYER = "towers: models/lthm/model.py, nn/"
MOVES = "serve_users_per_s"
SOURCE = "device_trace"


PHASES = ('lthm/mlp',)


def read(run):
    if run.trace is None or not run.trace.device_us(PHASES):
        return None
    return run.trace.device_us(PHASES) / run.trace.units / 1e3
