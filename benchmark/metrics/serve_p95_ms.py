"""The 95th percentile of every request's latency in the window: host clock
from the call to the synchronize after the vectors are copied back."""

from __future__ import annotations

from benchmark.harness.core import percentile

UNIT = "ms"
BETTER = "lower"
LAYER = ""
MOVES = ""
SOURCE = "host_clock"


def read(run):
    return 1e3 * percentile(run.latencies_s, 95.0)
