"""The readers of the program's layer ranges (``attention_ms.*``,
``mlp_ms.*``, ``product_tower_ms.*``, ``program_idle_ms.*``) on a
hand-built trace: each reads its own ranges' self time (a nested range takes
its work out of its parent's), and None where the program opens none of
its ranges, as a program without them does."""

from __future__ import annotations

import pytest

from benchmark.harness.core import ROOT, Run, Trace, load_module, phase_activity


def reader(name: str):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", "span_" + name.replace(".", "_"))


def user(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def kernel(corr, ts, dur, launch):
    """A kernel and the runtime call that launched it at ``launch``."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": launch, "dur": 1.0,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur, "args": {"correlation": corr}}]


def traced_unit(outer: str):
    """Two units (steps or requests), each one program call inside
    ``outer`` (``bench/step`` or ``bench/request``). The device runs without
    a break from the unit's start to 200 us and from 250 to 370; per unit,
    10 us are launched in ``lthm/product_tower``, 20 in ``lthm/attention``,
    30 in ``lthm/mlp``, 5 in ``lthm/attention_backward``, the rest in their
    parents. The gap 200-250 lies in ``lthm/logq`` (the host reading the
    device); the one before the next unit is the driver's."""
    events = [user("bench/window", 0.0, 1000.0)]
    corr = 0
    for s in (0.0, 400.0):
        events += [user(outer, s, 350.0), user("lthm/forward", s + 1, 300.0),
                   user("lthm/product_tower", s + 2, 10.0), user("lthm/attention", s + 20, 30.0),
                   user("lthm/mlp", s + 60, 40.0), user("lthm/logq", s + 200, 100.0),
                   user("lthm/attention_backward", s + 320, 5.0)]
        for ts, dur, launch in ((s, 10.0, s + 3), (s + 10, 20.0, s + 21), (s + 30, 30.0, s + 61),
                                (s + 60, 40.0, s + 110), (s + 100, 100.0, s + 130), (s + 250, 70.0, s + 240),
                                (s + 320, 5.0, s + 321), (s + 325, 45.0, s + 302)):
            corr += 1
            events += kernel(corr, ts, dur, launch)
    return events


@pytest.mark.parametrize("kind,outer", [("train", "bench/step"), ("serve", "bench/request")])
def test_bench_layer_readers_read_self_time(kind, outer):
    ops, idle = phase_activity(traced_unit(outer))
    trace = Trace(device_ops=[(n, d) for n, _, d, _ in ops], window_us=1000.0, busy_us=0.0, ops=ops,
                  idle_gaps=idle, units=2)
    run = Run(cell=None, seed=0, seconds=1.0, trace=trace)
    attention = 0.025 if kind == "train" else 0.020
    assert reader(f"attention_ms.{kind}").read(run) == pytest.approx(attention)
    assert reader(f"mlp_ms.{kind}").read(run) == pytest.approx(0.030)
    assert reader(f"product_tower_ms.{kind}").read(run) == pytest.approx(0.010)
    # the 50 us gap in lthm/logq a unit; the gaps between units are the driver's
    assert [n for n, _ in idle if n.startswith("lthm/")] == ["lthm/logq", "lthm/logq"]
    assert {n for n, _ in idle} - {"lthm/logq"} <= {outer, "other"}
    assert reader(f"program_idle_ms.{kind}").read(run) == pytest.approx(0.050)


@pytest.mark.parametrize("name", ["attention_ms.train", "attention_ms.serve", "mlp_ms.train", "mlp_ms.serve",
                                  "product_tower_ms.train", "product_tower_ms.serve", "program_idle_ms.train",
                                  "program_idle_ms.serve"])
def test_bench_layer_readers_are_none_without_their_ranges(name):
    """A program that opens none of the ranges (serving before them; every
    kernel in the driver's range), or a run with no trace."""
    outer = "bench/step" if name.endswith("train") else "bench/request"
    events = [user("bench/window", 0.0, 100.0), user(outer, 0.0, 100.0)]
    events += kernel(1, 10.0, 20.0, 5.0) + kernel(2, 60.0, 20.0, 40.0)
    ops, idle = phase_activity(events)
    trace = Trace(device_ops=[(n, d) for n, _, d, _ in ops], window_us=100.0, busy_us=40.0, ops=ops,
                  idle_gaps=idle, units=1)
    run = Run(cell=None, seed=0, seconds=1.0, trace=trace)
    assert idle and reader(name).read(run) is None
    run.trace = None
    assert reader(name).read(run) is None
