"""The readings the limits in ``benchmark/limits/`` were set from, at a
cell's own size, on the machine it runs on (not part of a benchmark run).

    python3 benchmark/controls.py --workload lthm_long.train --seeds 11 12 13 [--variants control half_batch]

For each seed it makes the cell's weights and inputs as a run does, runs the
plain reference in float32, and runs a variant in the program's place,
judged by the cell's own comparison:

- ``control``: the reference with every product's operands and the table
  lookup in float8 e4m3, the precision below the configuration's bf16;
- ``half_batch`` (training): the loss over the first half of each batch's
  users only, the mean taken over them;
- ``unchanged`` (training): the steps leave the parameters as they were;
  its ``change_gap`` reads 1 by construction.

A serving cell's variant recomputes 8 pool requests drawn from the seed.
Prints one JSON line a seed and variant: the numbers and the limits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["control"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import numpy as np
    import torch

    from benchmark.harness import checks
    from benchmark.harness.core import (SEED_OFFSETS, SEED_SAMPLE, SEED_TRAFFIC, SEED_WEIGHTS, benchmark_json,
                                        load_cell, load_module, sub_seed)
    from benchmark.harness.traffic import make_pool

    device = torch.device(args.device)
    cell = load_cell(benchmark_json(), args.workload)
    model = load_module(ROOT / "benchmark" / "models" / f"{cell.config['model']}.py", "bench_model")
    cfg = cell.model_cfg
    training = cell.traffic["driver"].startswith("train")
    for seed in args.seeds:
        pool = make_pool(cell.traffic, cell.config["history_length"], cfg["context_width"],
                         sub_seed(seed, SEED_TRAFFIC))
        weights = model.make_weights(cfg, sub_seed(seed, SEED_WEIGHTS), device)
        if training:
            batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in pool[:3]]
            t0 = time.perf_counter()
            ref = model.reference_train(cfg, weights, batches, sub_seed(seed, SEED_OFFSETS))
            ref_s = time.perf_counter() - t0
            for variant in args.variants:
                kw = {"control": {"precision": "fp8"}, "half_batch": {"users": cell.traffic["users"] // 2},
                      "unchanged": {"freeze": True}}[variant]
                other = model.reference_train(cfg, weights, batches, sub_seed(seed, SEED_OFFSETS), **kw)
                numbers = checks.train_numbers(other, ref)
                print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant, "numbers": numbers,
                                  "limits": cell.limits, "reference_s": ref_s,
                                  "losses": {"reference": ref["losses"], "variant": other["losses"]}}), flush=True)
        else:
            rng = np.random.default_rng(sub_seed(seed, SEED_SAMPLE))
            picks = rng.choice(len(pool), size=min(8, len(pool)), replace=False).tolist()
            for variant in args.variants:
                gaps, t0 = [], time.perf_counter()
                for k in picks:
                    batch = {key: torch.from_numpy(v).to(device) for key, v in pool[k].items()}
                    want = model.reference_serve(cfg, weights, batch)
                    got = model.reference_serve(cfg, weights, batch, precision="fp8")
                    gaps.append((got - want).norm(dim=-1))
                gaps = torch.cat(gaps)
                numbers = {"emb_gap_max": float(gaps.max()), "emb_gap_median": float(gaps.median())}
                print(json.dumps({"workload": args.workload, "seed": seed, "variant": variant, "numbers": numbers,
                                  "limits": cell.limits, "seconds": time.perf_counter() - t0}), flush=True)
        del weights
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
