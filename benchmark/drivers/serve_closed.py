"""Closed-loop serving: one client sends back-to-back requests from the
mix's pool to the program's serving entry.

A request goes from pinned host arrays to the user vectors copied back to
the host, and ends in a synchronize; its latency is the host clock over all
of that, its dispatch the call alone. Set-up warms the entry up on
``WARMUP`` requests of the pool. The window cycles through the pool. After
it, a ``--trace 1`` run profiles ``TRACE_REQUESTS`` more requests; then the
program is freed and the reference recomputes the requests of ``SAMPLE``
window positions drawn from the seed, each compared with what the window
served there.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.drivers.train_closed import pinned, sync
from benchmark.harness.core import SEED_SAMPLE, SEED_TRAFFIC, SEED_WEIGHTS, Run, sub_seed
from benchmark.harness.profiling import profiled
from benchmark.harness.traffic import make_pool

WARMUP = 2
TRACE_REQUESTS = 40
SAMPLE = 8


def run(run: Run, model, device: torch.device, trace: bool, clock) -> dict:
    """Fills ``run``; returns {"numbers", "attempted", "failed"}."""
    cell = run.cell
    cfg, hist = cell.model_cfg, cell.config["history_length"]
    pool = make_pool(cell.traffic, hist, cfg["context_width"], sub_seed(run.seed, SEED_TRAFFIC))
    host = pinned(pool, device)
    phases = {"pool": clock()}
    weights = model.make_weights(cfg, sub_seed(run.seed, SEED_WEIGHTS), device)
    wrapper = model.build_program(cfg, weights, device)
    del weights
    encode = model.serve_fn(wrapper)
    phases["program"] = clock()
    for i in range(WARMUP):
        encode(host[i % len(host)])["user_emb"].cpu()
    sync(device)
    run.setup_s = clock()
    run.extra["setup_phases"] = phases
    run.users_per_unit = cell.traffic["users"]

    # set-up's objects out of the collector's way: no long collection in the window
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    served, i = [], 0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        with record_function("bench/request"):
            out = encode(host[i % len(host)])["user_emb"]
            run.dispatch_s.append(time.perf_counter() - t)
            emb = out.cpu()
            sync(device)
        run.latencies_s.append(time.perf_counter() - t)
        served.append(emb)
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    gc.unfreeze()
    run.units = len(served)
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    users = cell.traffic["users"]
    item = cfg["product_tower"]["item_emb_dim"]
    failed = sum(1 for e in served if tuple(e.shape) != (users, item) or not bool(torch.isfinite(e).all())
                 or float((e.norm(dim=-1) - 1).abs().max()) > 1e-3)

    if trace:
        def more():
            for k in range(TRACE_REQUESTS):
                with record_function("bench/request"):
                    encode(host[(i + k) % len(host)])["user_emb"].cpu()
                    sync(device)

        run.trace = profiled(more, TRACE_REQUESTS, device)

    del encode, wrapper
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    rng = np.random.default_rng(sub_seed(run.seed, SEED_SAMPLE))
    picks = sorted(rng.choice(len(served), size=min(SAMPLE, len(served)), replace=False).tolist())
    weights = model.make_weights(cfg, sub_seed(run.seed, SEED_WEIGHTS), device)
    gaps = []
    for k in picks:
        batch = model.ready_batch(host[k % len(host)], device, False)
        want = model.reference_serve(cfg, weights, batch).cpu()
        got = served[k]
        gaps.append((got.float() - want).norm(dim=-1) if got.shape == want.shape
                    else torch.full((want.shape[0],), math.inf))
    gaps = torch.cat(gaps)
    run.extra["check_s"] = time.perf_counter() - t_check
    numbers = {"emb_gap_max": float(gaps.max()), "emb_gap_median": float(gaps.median())}
    return {"numbers": numbers, "attempted": run.units, "failed": failed}
