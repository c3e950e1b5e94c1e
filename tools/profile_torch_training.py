"""Where the time of an LTHM training step goes on the card.

    python3 tools/profile_torch_training.py [--steps 3] [--out traces/training_trace.json]
                                            [--eager-ce] [--production | --long-history | --moe | --sparse]
                                            [--context N] [--table-optimizer NAME]

Builds the LTHM-base model and training config that ``chip_smoke.py`` trains
(``bench.py``'s: random weights from a seed, ``fused_ce`` on, frozen table)
on the GPU, takes two warm-up steps on one batch of 64 users, and traces
``--steps`` more with ``torch.profiler``; ``--eager-ce`` profiles the step
with ``fused_ce`` off instead; ``--production`` profiles the production LTHM
of ``configs/model/lthm.yaml`` at context 1024 (``chip_smoke.production_config``:
16 layers with remat, the position-bias kernels) on 64 users of 1032 events;
``--long-history`` the long-history path of ``tools/bench_longseq.py``
(``chip_smoke.longseq_config``: LTHM-base widths with remat and no position
bias at context 1024, its eager CE) on 16 users of 1032 events; ``--sparse``
that path with the sparse keep-sets (``chip_smoke.sparse_config``: 512 of
the 1025 positions a block); ``--moe`` the MoE LTHM (``chip_smoke.moe_config``:
``lthm.yaml`` at context 512 with an MoE rotator) on 64 users of 520 events.
``--context N`` sets the production LTHM's context (and its bias window,
N + 1; 512 is ``lthm.yaml``'s own); ``--table-optimizer NAME`` trains the
product-embedding table (``detach_item_tower`` false) with NAME, ``auto``
included, on LTHM-base or the production LTHM; ``--dropout RATE`` trains
with both dropout rates at RATE and ``--accumulate K`` with K-step
gradient accumulation (steps are then micro-steps).
Prints the host time per step, the device's busy share of that window
(kernel time over wall time; one stream, so kernels do not overlap), the
device time of each phase of the step (the innermost ``lthm/...`` range of
``torch.profiler.record_function`` that launched each kernel: forward,
loss, backward, ce_backward, optimizer), and the kernels that take the most
device time, each with its launches per step (the fused CE's are
``row_diag_kernel``, ``ce_fwd_tc_kernel`` and ``ce_grad_tc_kernel``, whose last
template argument is 1 for ``ce_dq`` and 2 for ``ce_dc``),
and the port's own launch count of each of its kernels per step. Writes the
Chrome trace to ``--out``. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--out", default=os.path.join("traces", "training_trace.json"))
    ap.add_argument("--eager-ce", action="store_true", help="profile the step with fused_ce off")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--production", action="store_true", help="profile the production LTHM at context 1024")
    which.add_argument("--moe", action="store_true", help="profile the MoE LTHM at context 512")
    which.add_argument("--sparse", action="store_true", help="profile the long-history path with the keep-sets")
    which.add_argument("--long-history", action="store_true",
                       help="profile tools/bench_longseq.py's path (context 1024, 16 users)")
    ap.add_argument("--context", type=int, default=None, help="the production LTHM's context (default 1024)")
    ap.add_argument("--table-optimizer", default=None,
                    help="train the table with this table_optimizer (detach_item_tower false)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="train with this rate of token dropout (attn_dropout) and residual dropout (dropout)")
    ap.add_argument("--accumulate", type=int, default=1, help="gradient_accumulation_steps (optax.MultiSteps)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (BATCH, CTX512, LONG_BATCH, LONG_CONTEXT, PROD_CONTEXT, bench_config, longseq_config,
                            moe_config, production_config, request_batch, sparse_config)
    from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.ops import fused_attention as fa
    from recommendations_tpu_torch.ops import fused_ce as fc
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState

    if args.long_history or args.sparse:
        label = "long-history LTHM at context 1024" + (", sparse keep-sets" if args.sparse else "")
        users, cfg = LONG_BATCH, LTHMModelConfig.from_dict(sparse_config() if args.sparse else longseq_config())
        batch = request_batch(1000, users, LONG_CONTEXT + 8)
    elif args.moe:
        label, users, cfg = f"MoE LTHM at context {CTX512}", BATCH, LTHMModelConfig.from_dict(moe_config())
        batch = request_batch(1000, users, CTX512 + 8)
    else:
        context = args.context or PROD_CONTEXT
        base = production_config(context) if args.production else bench_config()
        label = f"production LTHM at context {context}" if args.production else "LTHM-base"
        if args.table_optimizer:
            base["table_optimizer"] = args.table_optimizer
            base["product_tower"]["detach_item_tower"] = False
            label += f", table_optimizer {args.table_optimizer}"
        users, cfg = BATCH, LTHMModelConfig.from_dict(dict(base, fused_ce=not args.eager_ce))
        batch = request_batch(1000, BATCH, context + 8) if args.production else request_batch(1000)
    if args.dropout:
        cfg.transformer_config.attn_config.dropout = cfg.transformer_config.attn_config.attn_dropout = args.dropout
        label += f", dropout {args.dropout}"
    if args.accumulate > 1:
        label += f", gradient accumulation {args.accumulate}"
    state = TrainState.create(LTHMModelWrapper(cfg, device="cuda", seed=0),
                              ModelTrainConfig(gradient_accumulation_steps=args.accumulate), seed=1)
    offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
    for _ in range(2):
        train_step(state, batch, offsets=offsets)
    torch.cuda.synchronize()

    kernels = (*fa.KERNELS, *fc.KERNELS)
    for kern in kernels:
        kern.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            train_step(state, batch, offsets=offsets)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    prof.export_chrome_trace(args.out)

    with open(args.out) as f:
        events = json.load(f)["traceEvents"]
    # launch time of each correlation id, and the lthm/... ranges
    launched = {
        e["args"]["correlation"]: e["ts"] for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
    }
    ranges = [
        (e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith("lthm/")
    ]

    def phase(kernel) -> str:
        t = launched.get(kernel.get("args", {}).get("correlation"))
        inside = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
        return min(inside, key=lambda r: r[1] - r[0])[2] if inside else "other"

    by_name = collections.defaultdict(lambda: [0.0, 0])
    by_phase = collections.defaultdict(lambda: [0.0, 0])
    busy_us = 0.0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy_us += e["dur"]
            by_name[e["name"]][0] += e["dur"]
            by_name[e["name"]][1] += 1
            by_phase[phase(e)][0] += e["dur"]
            by_phase[phase(e)][1] += 1
    n = args.steps
    print(f"{label}, fused_ce {'on' if cfg.fused_ce else 'off'}; the port's launches per step: "
          + ", ".join(f"{kern.name} {kern.launches // n}" for kern in kernels))
    print(f"{n} training steps of {users} users: {wall_us / n / 1e3:.3f} ms per step (host clock), "
          f"device busy {busy_us / n / 1e3:.3f} ms per step = "
          f"{100 * busy_us / wall_us:.1f}% of the window, "
          f"{sum(c for _, c in by_name.values()) // n} device operations per step")
    print("device time per step by phase (ms, operations per step, share of busy):")
    for name, (us, cnt) in sorted(by_phase.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / n / 1e3:9.4f}  {cnt // n:4d}  {100 * us / busy_us:5.1f}%  {name}")
    print("device time per step by kernel (ms, launches per step, share of busy):")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"  {us / n / 1e3:9.4f}  {cnt // n:4d}  {100 * us / busy_us:5.1f}%  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
