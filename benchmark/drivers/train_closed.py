"""Closed-loop training: back-to-back training steps through the program's
``train_step`` on batches from the mix's pool.

Set-up builds the train state once with the benchmark's weights, and
drives it through its first ``CHECKED_STEPS`` steps through the window's
own call and feed (pool batches 0, 1, 2: all rows differ); it records each
step's loss, the first gradient's leaf norms (from AdamW's state after step
1) and each leaf's change after the last of them. The same state then runs
the window, from pool batch 3 on, cycling through the pool: each step copies
its pinned batch to the device with ``non_blocking``, as the loader does.
The window ends in a synchronize. After it, a ``--trace 1`` run profiles
``TRACE_STEPS`` more steps; then the program's state is freed and the
reference follows the first steps on the same weights and batches.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch
from torch.profiler import record_function

from benchmark.harness import checks
from benchmark.harness.core import SEED_OFFSETS, SEED_TRAFFIC, SEED_WEIGHTS, Run, sub_seed
from benchmark.harness.profiling import profiled
from benchmark.harness.traffic import make_pool

CHECKED_STEPS = 3
TRACE_STEPS = 10


def pinned(pool, device: torch.device) -> List[Dict[str, torch.Tensor]]:
    out = []
    for batch in pool:
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        out.append({k: v.pin_memory() for k, v in b.items()} if device.type == "cuda" else b)
    return out


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(run: Run, model, device: torch.device, trace: bool, clock) -> dict:
    """Fills ``run``; returns {"numbers", "attempted", "failed"}."""
    cell = run.cell
    cfg, hist = cell.model_cfg, cell.config["history_length"]
    pool = make_pool(cell.traffic, hist, cfg["context_width"], sub_seed(run.seed, SEED_TRAFFIC))
    if len(pool) < CHECKED_STEPS + 1:
        raise ValueError("the pool must hold more batches than the checked steps")
    host = pinned(pool, device)
    phases = {"pool": clock()}
    offset_seed = sub_seed(run.seed, SEED_OFFSETS)
    weights = model.make_weights(cfg, sub_seed(run.seed, SEED_WEIGHTS), device)
    wrapper = model.build_program(cfg, weights, device)
    del weights
    state = model.train_state(wrapper, cell.config["train"], offset_seed)
    phases["program"] = clock()
    step = model.train_step_fn()
    start = {n: p.detach().clone() for n, p in model.trained_params(state).items()}
    prog = {"losses": [], "grad_norms": {}, "change_norms": {}}
    for i in range(CHECKED_STEPS):
        loss, _ = step(state, model.ready_batch(host[i], device, True))
        prog["losses"].append(loss.item())
        if i == 0:
            prog["grad_norms"] = model.first_grad_norms(state)
            phases["first step"] = clock()
    prog["change_norms"] = {n: (p.detach() - start[n]).norm().item() for n, p in model.trained_params(state).items()}
    del start
    sync(device)
    run.setup_s = clock()
    run.extra["setup_phases"] = phases
    run.users_per_unit = cell.traffic["users"]

    # set-up's objects out of the collector's way: no long collection in the window
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, i = [], CHECKED_STEPS
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        with record_function("bench/step"):
            loss, _ = step(state, model.ready_batch(host[i % len(host)], device, True))
        run.dispatch_s.append(time.perf_counter() - t)
        losses.append(loss)
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    sync(device)
    run.window_s = time.perf_counter() - t0
    gc.unfreeze()
    run.units = len(losses)
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    failed = int((~torch.isfinite(torch.stack(losses))).sum().item())

    if trace:
        def more():
            nonlocal i
            for _ in range(TRACE_STEPS):
                with record_function("bench/step"):
                    step(state, model.ready_batch(host[i % len(host)], device, True))
                i += 1
            sync(device)

        run.trace = profiled(more, TRACE_STEPS, device)

    del state, wrapper, losses, loss
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    with torch.no_grad():
        weights = model.make_weights(cfg, sub_seed(run.seed, SEED_WEIGHTS), device)
    batches = [model.ready_batch(h, device, False) for h in host[:CHECKED_STEPS]]
    ref = model.reference_train(cfg, weights, batches, offset_seed)
    run.extra["program"], run.extra["reference"] = prog, ref
    numbers = checks.train_numbers(prog, ref)
    run.extra["check_s"] = time.perf_counter() - t_check
    return {"numbers": numbers, "attempted": run.units, "failed": failed}
