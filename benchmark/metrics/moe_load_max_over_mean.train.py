"""The most loaded expert's (token, slot) rows over the mean expert's, in
the MoE layer where that is largest: read from the program's counters
``lthm/moe_tokens/<layer>`` (``recommendations_tpu_torch.core.spans``),
which count the rows routed to each expert while a profiler records (the
profiled sub-windows of a ``--trace 1`` run), read after them. None when
the program has no such counter or nothing was counted."""

from __future__ import annotations

UNIT = "ratio"
BETTER = "lower"
LAYER = "towers: models/lthm/model.py, nn/"
MOVES = "train_examples_per_s"
SOURCE = "program_counter"

PREFIX = "lthm/moe_tokens/"


def read(run):
    if run.trace is None:
        return None
    try:
        from recommendations_tpu_torch.core import spans
    except ImportError:
        return None
    counters = getattr(spans, "counters", None)
    if counters is None:
        return None
    loads = [c.double().cpu() for name, c in counters().items() if name.startswith(PREFIX)]
    loads = [c for c in loads if c.numel() and float(c.sum()) > 0]
    if not loads:
        return None
    return max(float(c.max() / c.mean()) for c in loads)
