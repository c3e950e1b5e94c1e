"""Device time of the kernels launched in ``lthm/attention`` (an attention
layer's forward: the projections, the bias kernel or ``_sdpa``,
``out_proj``; opened again in remat's rerun) and ``lthm/attention_backward``
(the flash kernels' dQ, dK/dV and bias-table gradient), per step. None when
the range is absent."""

from __future__ import annotations

UNIT = "ms"
BETTER = "lower"
LAYER = "towers: models/lthm/model.py, nn/"
MOVES = "train_examples_per_s"
SOURCE = "device_trace"


PHASES = ('lthm/attention', 'lthm/attention_backward')


def read(run):
    if run.trace is None or not run.trace.device_us(PHASES):
        return None
    return run.trace.device_us(PHASES) / run.trace.units / 1e3
