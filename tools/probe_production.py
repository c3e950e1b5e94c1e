"""The production LTHM's training step and request with this checkout's
kernels and with another copy of ``recommendations_tpu_torch/ops/csrc``, in
turns, in one process on one NVIDIA GPU.

    python3 tools/probe_production.py --other traces/parent_csrc [--steps 3] [--requests 4] [--rounds 2]

Builds the production LTHM of ``configs/model/lthm.yaml`` at context 1024
(``chip_smoke.production_config``: 16 layers with remat, the position-bias
kernels, ``fused_ce`` on, random weights from a seed) once, then in turns
(other, this, this, other, per round) points every kernel of the port at one
tree's sources (their C entries are the same, but for a ``ce_row_diag`` that
takes no lq: it is bound with its own signature and given the shift's four
operations before it, as in ``tools/probe_fused_ce.py``), takes a warm-up
step and a warm-up request, and times ``--steps`` training steps of 64 users on one
batch with fixed lookahead offsets and ``--requests`` requests of 64 users
(host clock around work that ends in ``torch.cuda.synchronize()``), then one
step and one request under ``torch.profiler`` for their device time (kernel
time summed). Prints one line per turn, the card's name and power limit,
and a JSON summary as its last line. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="a directory with another copy of ops/csrc")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2, help="rounds of (other, this, this, other)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("probe_production: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import BATCH, PROD_CONTEXT, production_config, request_batch
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.ops import cuda_build
    from recommendations_tpu_torch.ops import fused_attention as fa
    from recommendations_tpu_torch.ops import fused_ce as fc
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState
    from tools.probe_fused_ce import ce_forward_shift_apart, row_diag_argtypes

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    kernels = [*fa.KERNELS, *fc.KERNELS, fa._BIAS_DKV_SLICES, fa._FWD_TILES_PER_BLOCK, fa._DKV_ITEMS_PER_BLOCK]
    trees = {"this": cuda_build.CSRC, "other": Path(args.other).resolve()}
    sources = {tree / kern.source.name for tree in trees.values() for kern in kernels}
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        list(pool.map(cuda_build.build_library, sources))

    own_row_diag, own_forward = fc.CE_ROW_DIAG.argtypes, fc.ce_forward

    def use(tree: Path) -> None:
        for kern in kernels:
            kern.source = tree / kern.source.name
            kern._fn = None
        # a tree whose ce_row_diag takes no lq forms the shift as it did, apart
        fc.CE_ROW_DIAG.argtypes = row_diag_argtypes(tree / "fused_ce.cu", own_row_diag)
        fc.ce_forward = own_forward if fc.CE_ROW_DIAG.argtypes is own_row_diag else ce_forward_shift_apart

    cfg = LTHMModelConfig.from_dict(production_config())
    wrapper = LTHMModelWrapper(cfg, device="cuda", seed=0)
    encode = wrapper.inference_models()["user_encoder"]
    state = TrainState.create(wrapper, seed=1)
    events = PROD_CONTEXT + 8
    batch = request_batch(2000, BATCH, events)
    requests = [request_batch(seed, BATCH, events) for seed in range(101, 101 + args.requests)]
    offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def device_ms(fn) -> float:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(ev.self_device_time_total for ev in prof.key_averages()) / 1e3

    res = {"device": smi, "this": [], "other": []}
    for tree in ("other", "this", "this", "other") * args.rounds:
        use(trees[tree])
        train_step(state, batch, offsets=offsets)  # warm-up
        encode(requests[0])
        torch.cuda.synchronize()
        steps = [timed(lambda: train_step(state, batch, offsets=offsets)) for _ in range(args.steps)]
        reqs = [timed(lambda r=r: encode(r)) for r in requests]
        turn = {"step_median_ms": statistics.median(steps), "step_ms": steps,
                "request_median_ms": statistics.median(reqs), "request_ms": reqs,
                "step_device_ms": device_ms(lambda: train_step(state, batch, offsets=offsets)),
                "request_device_ms": device_ms(lambda: encode(requests[0]))}
        res[tree].append(turn)
        print(f"[turn] {tree}: step median {turn['step_median_ms']:.3f} ms of {[round(x, 3) for x in steps]}, "
              f"device {turn['step_device_ms']:.3f} ms; request median {turn['request_median_ms']:.3f} ms of "
              f"{[round(x, 3) for x in reqs]}, device {turn['request_device_ms']:.3f} ms", flush=True)
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
