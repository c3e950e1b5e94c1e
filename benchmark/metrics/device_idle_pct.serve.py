"""The device's idle share of the profiled sub-window: one less the time in
which some kernel, copy or set ran (the union of their spans, in the profile
of the device alone) over that sub-window's length on the host clock, the
result's ``busy_s`` and ``window_s``. The sub-window is the ``TRACE_REQUESTS``
requests after the measured window, begun and ended by a synchronize."""

from __future__ import annotations

UNIT = "%"
BETTER = "lower"
LAYER = "device"
MOVES = "serve_users_per_s"
SOURCE = "device_trace"


def read(run):
    if run.trace is None or not run.trace.device_ops or run.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us / run.trace.window_us)
