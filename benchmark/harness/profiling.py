"""The profiled sub-windows of a ``--trace 1`` run, after the measured
window: ``torch.profiler`` of the device alone over a few more steps or
requests (busy and idle time, device time by kernel), then of the device and
the host's ranges over as many more (device time by the ``lthm/`` range that
launched it, idle gaps by what the host was doing). Each Chrome trace is
written to a temporary directory under ``TMPDIR`` and reduced there."""

from __future__ import annotations

import tempfile
import time
from pathlib import Path
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness.core import Trace, device_activity, phase_activity, trace_events


def _traced(fn: Callable[[], None], activities, tmp: Path, name: str):
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function("bench/window"):
            fn()
        wall_us = (time.perf_counter() - t0) * 1e6
    path = tmp / name
    prof.export_chrome_trace(str(path))
    return trace_events(path), wall_us


def profiled(fn: Callable[[], None], units: int, device: torch.device) -> Trace:
    """Profile ``fn`` (``units`` steps or requests, ending in a
    synchronize) twice, as the module says."""
    cuda = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        events, wall_us = _traced(fn, cuda or [ProfilerActivity.CPU], Path(tmp), "device.json")
        device_ops, busy_us = device_activity(events)
        events, _ = _traced(fn, [ProfilerActivity.CPU] + cuda, Path(tmp), "ranges.json")
        ops, idle = phase_activity(events)
    return Trace(device_ops=device_ops, window_us=wall_us, busy_us=busy_us, ops=ops, idle_gaps=idle, units=units)
