"""Where the time of an LTHM user-encoder request goes on the card.

    python3 tools/profile_torch_serving.py [--requests 4] [--out traces/serving_trace.json]
                                           [--production | --long-history]

Builds the LTHM-base model of ``chip_smoke.py`` (random weights from a seed)
on the GPU, or with ``--production`` the production LTHM of
``configs/model/lthm.yaml`` at context 1024 (``chip_smoke.production_config``)
with requests of 1032 events, or with ``--long-history`` the long-history
path of ``tools/bench_longseq.py`` (``chip_smoke.longseq_config``, context
1024, 16 users of 1032 events), warms it up, and traces ``--requests``
requests (of 64 users, but 16 on the long-history path) with
``torch.profiler``. Prints the host time per request, the device's busy share
of that window (kernel time over wall time; one stream, so kernels do not
overlap), and the kernels that take the most device time. Writes the Chrome
trace to ``--out``. Needs a card; imports nothing of JAX.
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
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--out", default=os.path.join("traces", "serving_trace.json"))
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--production", action="store_true", help="profile the production LTHM at context 1024")
    which.add_argument("--long-history", action="store_true",
                       help="profile tools/bench_longseq.py's path (context 1024, 16 users)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (BATCH, LONG_BATCH, LONG_CONTEXT, PROD_CONTEXT, bench_config, longseq_config,
                            production_config, request_batch)
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper

    base = longseq_config() if args.long_history else production_config() if args.production else bench_config()
    wrapper = LTHMModelWrapper(LTHMModelConfig.from_dict(base), device="cuda", seed=0)
    encode = wrapper.inference_models()["user_encoder"]
    events = LONG_CONTEXT + 8 if args.long_history else PROD_CONTEXT + 8 if args.production else None
    users = LONG_BATCH if args.long_history else BATCH
    batches = [request_batch(seed, users, events) if events else request_batch(seed)
               for seed in range(1, args.requests + 1)]
    for b in batches[:2]:
        encode(b)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            encode(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    prof.export_chrome_trace(args.out)

    with open(args.out) as f:
        events = json.load(f)["traceEvents"]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    busy_us = 0.0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy_us += e["dur"]
            by_name[e["name"]][0] += e["dur"]
            by_name[e["name"]][1] += 1
    n = args.requests
    print(f"{n} requests: {wall_us / n / 1e3:.3f} ms per request (host clock), "
          f"device busy {busy_us / n / 1e3:.3f} ms per request = "
          f"{100 * busy_us / wall_us:.1f}% of the window")
    print("device time per request by kernel (ms, launches per request, share of busy):")
    for name, (us, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {us / n / 1e3:9.4f}  {cnt // n:4d}  {100 * us / busy_us:5.1f}%  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
