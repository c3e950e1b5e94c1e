"""The device's idle time inside the program, per step: the ranged profile's
idle gaps whose middle lies in an ``lthm/`` range (the innermost range open
on the host then names the gap), over the steps. The gaps the driver makes,
in ``bench/step`` or in no range, are left out. None when the program opens
no ``lthm/`` range."""

from __future__ import annotations

UNIT = "ms"
BETTER = "lower"
LAYER = "device"
MOVES = "train_examples_per_s"
SOURCE = "device_trace"


def read(run):
    if run.trace is None or not any(phase.startswith("lthm/") for *_, phase in run.trace.ops):
        return None
    idle_us = sum(us for name, us in run.trace.idle_gaps if name.startswith("lthm/"))
    return idle_us / run.trace.units / 1e3
