"""The LFM2 backbone of the port on one NVIDIA GPU: its attention routes
timed, and its agreement with the benchmark's plain reference at the
``lthm_lfm2moe.train`` cell's size.

    python3 tools/probe_lfm2.py attention            # the two GQA routes, timed
    python3 tools/probe_lfm2.py agreement --seed 7   # routing, load and serving against the reference

``attention``: one GQA layer's core (32 query heads over 8 KV heads, hd 64,
bf16, causal) at B=64, T=1025, forward and backward, timed with CUDA events
in turns: (a) ``scaled_dot_product_attention`` with ``enable_gqa``, as
``nn/lfm2.GQAttention`` runs it; (b) K and V repeated to 32 heads and
passed to the port's multi-head flash kernel (``ops/fused_attention``).
The outputs of the two are compared first.

``agreement``: the cell's weights and pool batch 0 from ``--seed`` (as a
run makes them), the program's ``user_encoder`` on it, then the plain
float32 reference's: the largest and median distance between the served
vectors, and the share of (position, expert) choices of each MoE layer
that the program makes and the reference does not. Also each MoE layer's
load in the program (the busiest expert's rows over the mean, over all
rows and over the events' rows), with the drawn expert bias and with the
balanced one (``benchmark/models/lthm_lfm2.py``), and the time
``make_weights`` takes with the balancing.

Prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def card() -> str:
    import torch

    return f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; cuda {torch.version.cuda}"


def attention(reps: int) -> dict:
    import torch
    import torch.nn.functional as F

    from recommendations_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    b, t, h, kv, hd = 64, 1025, 32, 8, 64
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, t, h, hd, device=dev, generator=gen, dtype=torch.bfloat16).requires_grad_(True)
    k = torch.randn(b, t, kv, hd, device=dev, generator=gen, dtype=torch.bfloat16).requires_grad_(True)
    v = torch.randn(b, t, kv, hd, device=dev, generator=gen, dtype=torch.bfloat16).requires_grad_(True)
    do = torch.randn(b, t, h * hd, device=dev, generator=gen, dtype=torch.bfloat16)

    def sdpa():
        y = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                           is_causal=True, enable_gqa=True)
        return y.transpose(1, 2).reshape(b, t, h * hd)

    def repeated():
        kr = k.repeat_interleave(h // kv, dim=2).reshape(b, t, h * hd)
        vr = v.repeat_interleave(h // kv, dim=2).reshape(b, t, h * hd)
        return fa.fused_flash_attention(q.reshape(b, t, h * hd), kr, vr, h, True)

    routes = {"sdpa_enable_gqa": sdpa, "repeat_kv_flash": repeated}
    out = {"card": card(), "shape": [b, t, h, kv, hd]}
    with torch.no_grad():
        ya = sdpa()
        try:
            out["max_abs_diff"] = float((ya.float() - repeated().float()).abs().max())
        except ValueError as e:  # the kernel does not take the shape
            out["repeat_kv_flash"] = str(e)
            del routes["repeat_kv_flash"]

    def timed(fn, backward: bool) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(3):
            y = fn()
            if backward:
                y.backward(do)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            y = fn()
            if backward:
                y.backward(do)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for order in (list(routes), list(routes)[::-1]):
        for name in order:
            with torch.no_grad():
                fwd = timed(routes[name], False)
            both = timed(routes[name], True)
            out.setdefault(name, []).append({"forward_ms": fwd, "forward_backward_ms": both})
    return out


def loads(choices, events, experts: int) -> dict:
    """Each MoE layer's busiest expert's rows over the mean expert's, over
    all rows and over the rows of events (not padding, not the CLS column)."""
    out = {"all": [], "events": []}
    for c in choices:
        for key, rows in (("all", c), ("events", c[events])):
            n = rows.reshape(-1).bincount(minlength=experts).double()
            out[key].append(float(n.max() / n.mean()))
    return out


def agreement(seed: int) -> dict:
    import torch

    sys.path[0] = str(ROOT)
    from benchmark.harness.core import SEED_TRAFFIC, SEED_WEIGHTS, benchmark_json, load_cell, load_module, sub_seed
    from benchmark.harness.traffic import make_pool
    from benchmark.reference import lthm_lfm2 as ref
    from recommendations_tpu_torch.nn.lfm2 import RoutedMoE

    dev = torch.device("cuda")
    cell = load_cell(benchmark_json(), "lthm_lfm2moe.train")
    model = load_module(ROOT / "benchmark" / "models" / f"{cell.config['model']}.py", "bench_model")
    cfg = cell.model_cfg
    cw, tc = cfg["context_width"], cfg["transformer_config"]
    pool = make_pool(cell.traffic, cell.config["history_length"], cw, sub_seed(seed, SEED_TRAFFIC))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pool[0].items()}
    # the stack's rows (user, position): the CLS column, then the events oldest first, left-padded
    ids = torch.flip(batch["product_ids"], dims=(1,))[:, -cw:]
    events = torch.cat([torch.zeros_like(ids[:, :1], dtype=torch.bool), ids != 0], dim=1).reshape(-1)
    out = {"card": card(), "seed": seed, "event_share": float(events.float().mean())}

    def program_choices(weights):
        wrapper = model.build_program(cfg, weights, dev)
        chosen = []

        def record(mod, args):
            chosen.append(mod.route(args[0].reshape(-1, args[0].shape[-1])))

        for m in wrapper.module.modules():
            if isinstance(m, RoutedMoE):
                m.register_forward_pre_hook(record)
        t0 = time.perf_counter()
        with torch.no_grad():
            got = model.serve_fn(wrapper)(batch)["user_emb"].float()
        torch.cuda.synchronize()
        del wrapper
        torch.cuda.empty_cache()
        return got, chosen, time.perf_counter() - t0

    _, drawn, _ = program_choices(model.make_weights(cfg, sub_seed(seed, SEED_WEIGHTS), dev, balance=False))
    out["load_drawn_bias"] = loads(drawn, events, tc["num_experts"])
    del drawn
    t0 = time.perf_counter()
    weights = model.make_weights(cfg, sub_seed(seed, SEED_WEIGHTS), dev)
    torch.cuda.synchronize()
    out["make_weights_s"] = time.perf_counter() - t0
    got, chosen, out["program_s"] = program_choices(weights)
    out["load_balanced_bias"] = loads(chosen, events, tc["num_experts"])
    record = []

    def on_route(pre, scores):
        record.append(torch.topk(scores + weights[pre + "expert_bias"], tc["num_experts_per_tok"], dim=-1).indices)

    t0 = time.perf_counter()
    want = ref.user_embeddings(cfg, weights, batch, ref.Precision("f32"), on_route=on_route)
    out["reference_s"] = time.perf_counter() - t0
    gaps = (got - want).norm(dim=-1)
    differ = []
    for a, b in zip(chosen, record):
        same = (a[:, :, None] == b[:, None, :]).any(-1)
        differ.append(float(1.0 - same.float().mean()))
    out.update(emb_gap_max=float(gaps.max()), emb_gap_median=float(gaps.median()),
               choice_differ_share_by_moe_layer=differ)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("attention", "agreement"))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    out = attention(args.reps) if args.what == "attention" else agreement(args.seed)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
