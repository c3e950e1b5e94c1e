"""The device's peak allocated memory over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``).
It guards a speed bought with memory."""

from __future__ import annotations

UNIT = "GiB"
BETTER = "lower"
LAYER = ""
MOVES = ""
SOURCE = "host_clock"


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
