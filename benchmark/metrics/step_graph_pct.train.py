"""The share of the process's training steps that replayed the captured
step: 100 * replays / (replays + eager), from the program's host tallies
``lthm/step_graph/replays`` and ``lthm/step_graph/eager``
(``recommendations_tpu_torch.core.spans``), read after the run. The checked
steps' warm-up and the profiled sub-windows run eager, the measured window
replays. None when the program has no such tally or counted no step."""

from __future__ import annotations

UNIT = "%"
BETTER = "higher"
LAYER = "entry: train/step.py, models/lthm/wrapper.py"
MOVES = "train_examples_per_s"
SOURCE = "program_counter"

PREFIX = "lthm/step_graph/"


def read(run):
    try:
        from recommendations_tpu_torch.core import spans
    except ImportError:
        return None
    counters = getattr(spans, "counters", None)
    if counters is None:
        return None
    counts = {name[len(PREFIX):]: float(c.sum()) for name, c in counters().items() if name.startswith(PREFIX)}
    total = counts.get("replays", 0.0) + counts.get("eager", 0.0)
    return 100.0 * counts.get("replays", 0.0) / total if total else None
