"""One run of one cell: resolve its files, let its driver run set-up, the
window and the check, read its metrics, and assemble the result line."""

from __future__ import annotations

import math
import statistics
from pathlib import Path
from typing import Callable, List, Tuple

import torch

from benchmark.harness import checks
from benchmark.harness.core import (
    ROOT,
    Run,
    benchmark_json,
    breakdown,
    load_cell,
    load_module,
    percentile,
    workload_metrics,
)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
             clock: Callable[[], float], root: Path = ROOT) -> Tuple[dict, List[str]]:
    """(result, the lines for standard error: each number compared beside
    its limit last)."""
    bench = benchmark_json(root)
    cell = load_cell(bench, workload, root)
    bdir = root / "benchmark"
    model = load_module(bdir / "models" / f"{cell.config['model']}.py", f"bench_model_{cell.config['model']}")
    driver = load_module(bdir / "drivers" / f"{cell.traffic['driver']}.py", f"bench_driver_{cell.traffic['driver']}")
    run = Run(cell=cell, seed=seed, seconds=seconds)
    run.shapes = model.shapes(cell.model_cfg, cell.traffic["users"], cell.config["history_length"])
    run.extra["on_chip"] = device.type == "cuda"
    out = driver.run(run, model, device, trace, clock)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in workload_metrics(bench, workload, kind):
        reader = load_module(bdir / "metrics" / f"{m['name']}.py", f"bench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    numbers, limits = out["numbers"], cell.limits
    correct = checks.judge(numbers, limits) and out["failed"] == 0
    device_info = {"memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    lines = [f"window: {run.units} {'requests' if run.latencies_s else 'steps'} of {run.users_per_unit} users "
             f"in {run.window_s:.4f} s; setup {run.setup_s:.4f} s; the check took {run.extra.get('check_s', 0.0):.1f} s"]
    if "setup_phases" in run.extra:
        lines.append("setup: " + ", ".join(f"{k} done at {v:.3f} s" for k, v in run.extra["setup_phases"].items()))
    if run.dispatch_s and not run.latencies_s:
        d = [x * 1e3 for x in run.dispatch_s]
        lines.append(f"steps: dispatch median {statistics.median(d):.4f} ms, min {min(d):.4f}, p90 "
                     f"{percentile(d, 90.0):.4f}, max {max(d):.4f}; first three {[round(x, 3) for x in d[:3]]}")
    if run.latencies_s:
        lat = [x * 1e3 for x in run.latencies_s]
        lines.append(f"latency: median {statistics.median(lat):.4f} ms, p90 {percentile(lat, 90.0):.4f}, p95 "
                     f"{percentile(lat, 95.0):.4f}, p99 {percentile(lat, 99.0):.4f}, max {max(lat):.4f} ms over "
                     f"{len(lat)} requests")
    if trace and run.trace is not None:
        device_info.update(busy_s=run.trace.busy_us / 1e6, window_s=run.trace.window_us / 1e6)
        result["breakdown"] = breakdown(run.trace)
    if "reference" in run.extra:
        prog, ref = run.extra["program"], run.extra["reference"]
        lines.append(f"losses: program {prog['losses']!r}, reference {ref['losses']!r}; worst leaves: gradient "
                     f"{checks.worst_leaf(prog['grad_norms'], ref['grad_norms'])}, change "
                     f"{checks.worst_leaf(prog['change_norms'], ref['change_norms'])}")
    result["checks"] = checks.lines(numbers, limits)
    lines += [f"check {k}: {numbers.get(k, float('nan'))!r} (limit {lim!r})" for k, lim in limits.items()]
    return result, lines
