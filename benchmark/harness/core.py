"""What the harness finds by name, and what a run records.

Everything that belongs to one configuration, traffic mix, metric, driver or
model lives in a file of its own under ``benchmark/``, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration; its ``model`` names
  ``models/<model>.py``, which builds and drives the program and runs the
  reference;
- ``traffic/<mix>.json``: the mix's parameters; its ``driver`` names
  ``drivers/<driver>.py``, which runs set-up, the window and the check;
- ``metrics/<metric>.py``: the reader of one metric;
- ``limits/<workload>.json``: the limit of each number the cell's check
  compares.

A later change adds a cell, a mix or a metric by adding such files.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "recommendations_tpu")


def benchmark_json(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file by path (metric files carry dots in their names)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload_metrics(bench: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries a cell reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def sub_seed(seed: int, what: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    return int(np.random.SeedSequence([seed % 2**64, what]).generate_state(1, np.uint64)[0] >> np.uint64(1))


SEED_WEIGHTS, SEED_TRAFFIC, SEED_OFFSETS, SEED_SAMPLE = 1, 2, 3, 4


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


@dataclass
class Cell:
    """One workload with its files resolved."""

    name: str
    config_name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]

    @property
    def model_cfg(self) -> dict:
        return self.config["model_config"]


def load_cell(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    w = entry(bench["workloads"], workload, "workload")
    c = entry(bench["configs"], w["config"], "configuration")
    config = read_json(root / c["file"])
    traffic = read_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    limits = read_json(root / "benchmark" / "limits" / f"{workload}.json")
    return Cell(workload, w["config"], config, traffic, limits)


@dataclass
class Trace:
    """The profiled sub-windows of a run, reduced. ``device_ops`` (name,
    microseconds), ``busy_us`` and ``window_us`` come from a profile of the
    device alone, whose window is the host clock around its steps or
    requests; ``ops`` (name, start, microseconds, phase) and ``idle_gaps``
    (what the host was doing, microseconds) from a second profile that also
    records the host's ``lthm/`` and ``bench/`` ranges, which slows the
    host, so its gaps are longer than the window's."""

    device_ops: List[tuple]
    window_us: float
    busy_us: float
    ops: List[tuple]
    idle_gaps: List[tuple]
    units: int  # steps or requests in each sub-window

    def device_us(self, phases=None, names=None) -> float:
        """Device time of the ops launched in ``phases`` (from the ranged
        profile), or of those named in ``names`` (base names, from the
        device profile), or of every op of the device profile."""
        if phases is not None:
            return sum(dur for _, _, dur, phase in self.ops if phase in phases)
        return sum(dur for name, dur in self.device_ops if names is None or base_name(name) in names)

    def has(self, names) -> bool:
        return any(base_name(op[0]) in names for op in self.device_ops)


def base_name(kernel: str) -> str:
    """A device op's name without its return type, template arguments,
    parameters and anonymous namespaces: ``void (anonymous
    namespace)::mqa_tc_bias_fwd_kernel<16, 2>(...)`` ->
    ``mqa_tc_bias_fwd_kernel``."""
    n = kernel.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    out, depth = [], 0
    for ch in n:
        if ch == "(" and depth == 0:
            break
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()


@dataclass
class Run:
    """What one run measured, for the metric readers."""

    cell: Cell
    seed: int
    seconds: float
    setup_s: float = math.nan
    window_s: float = math.nan
    units: int = 0  # steps or requests in the window
    users_per_unit: int = 0
    latencies_s: List[float] = field(default_factory=list)  # per request, call to synchronize
    dispatch_s: List[float] = field(default_factory=list)  # per call, call to return
    peak_bytes: int = 0
    trace: Optional[Trace] = None
    shapes: Any = None
    extra: Dict[str, Any] = field(default_factory=dict)


def percentile(values: List[float], p: float) -> float:
    """The p-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), p))


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(path: Path) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def device_activity(events: List[dict]) -> tuple:
    """(ops as (name, microseconds), busy microseconds: the union of every
    kernel, copy and set)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    busy, cursor = 0.0, -math.inf
    for a, b, _ in spans:
        busy += max(0.0, b - max(a, cursor))
        cursor = max(cursor, b)
    return [(n, b - a) for a, b, n in spans], busy


def phase_activity(events: List[dict], window_name: str = "bench/window") -> tuple:
    """(ops as (name, start, microseconds, phase), idle gaps as (range,
    microseconds), longest first) within the host range ``window_name``:
    each op is named by the innermost ``lthm/`` or ``bench/`` range open on
    the host when it was launched (matched by correlation id), each gap by
    the innermost such range open at its middle."""
    launched, ranges, window = {}, [], None
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launched[e["args"]["correlation"]] = e["ts"]
        elif cat == "user_annotation" and e.get("ph") == "X":
            if name == window_name:
                window = (e["ts"], e["ts"] + e["dur"])
            elif name.startswith(("lthm/", "bench/")):
                ranges.append((e["ts"], e["ts"] + e["dur"], name))
    if window is None:
        raise RuntimeError(f"the trace has no {window_name!r} range")
    ranges.sort(key=lambda r: r[1] - r[0])  # innermost first

    def inner(t: Optional[float]) -> str:
        if t is None:
            return "other"
        for a, b, n in ranges:
            if a <= t <= b:
                return n
        return "other"

    ops = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            a, b = max(e["ts"], window[0]), min(e["ts"] + e["dur"], window[1])
            if b > a:
                ops.append((e["name"], a, b - a, inner(launched.get(e.get("args", {}).get("correlation")))))
    gaps, cursor = [], window[0]
    for _, a, dur, _ in sorted(ops, key=lambda o: o[1]):
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, a + dur)
    if window[1] > cursor:
        gaps.append((cursor, window[1]))
    idle = sorted(((inner((a + b) / 2), b - a) for a, b in gaps), key=lambda g: -g[1])
    return ops, idle


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops that took most time and the longest idle gaps, in
    seconds."""
    by_name: Dict[str, float] = {}
    for name, dur in trace.device_ops:
        key = base_name(name)
        by_name[key] = by_name.get(key, 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in trace.idle_gaps[:top]]}
