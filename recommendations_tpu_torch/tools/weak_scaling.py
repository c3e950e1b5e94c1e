"""Weak-scaling measurement: examples/s a rank at a fixed batch a rank.

Port of ``recommendations_tpu/tools/weak_scaling.py``. For each rank count
it starts that many processes joined by a process group, trains the same
tiny LTHM data-parallel (the mesh's ``data`` axis, ``train/step.py``'s
gradient all-reduce) with a FIXED batch a rank, and reports throughput and
the efficiency against the first count:

    python -m recommendations_tpu_torch.tools.weak_scaling --device cpu --ranks 1 2 4

``--device cpu`` joins the ranks by gloo on the host's cores, which the
ranks share, so the efficiency there measures host contention, not a
network; ``--device cuda`` puts rank r on ``cuda:r`` joined by NCCL (one
card a rank). Each line names the regime it measured.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from recommendations_tpu_torch import resolve_device


def _tiny_config(seq: int) -> dict:
    """The JAX tool's model: 2 layers, d=64, MQA 4 heads, a 65536-row table."""
    return dict(
        features={"defaults": {}},
        transformer_config=dict(
            rotator_config={"ff_mult": 2}, is_causal=True, num_layers=2,
            attn_config=dict(n_head=4, n_embd=64, attn_type="multi_query", dropout=0.0, attn_dropout=0.0,
                             bias=False),
        ),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=64, product_emb_dim=32, norm_bins=4,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 8}],
            latent_model_config={"vocab_size_latent": 65536, "num_shifts_latent": 4, "normalize_embedding": True},
        ),
        log_q_config={"num_buckets": 65536, "hash_offsets": [0, 7]},
        lookahead=[0, 2, 4], context_width=seq, train_mini_batch_size=-1,
    )


def _batch(rows: int, seq: int, seed: int) -> dict:
    rs = np.random.RandomState(seed)
    ids = rs.randint(-(2**62), 2**62, size=(rows, seq)).astype(np.int64)
    ids[:, -4:] = 0
    return {
        "product_ids": ids,
        "labels": rs.randint(0, 4, size=ids.shape).astype(np.float32),
        "timestamps": rs.randint(1_600_000_000, 1_700_000_000, size=ids.shape).astype(np.float32),
    }


def _rank(rank: int, n: int, port: int, device: str, per_rank_batch: int, seq: int, steps: int, out: str) -> None:
    import torch.distributed as dist

    from recommendations_tpu_torch.core.mesh import MeshConfig, build_mesh
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState

    torch.set_num_threads(1)
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    if n > 1:
        kw = {"device_id": dev} if device == "cuda" else {}
        dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=n, rank=rank, timeout=datetime.timedelta(seconds=60), **kw)
    wrapper = LTHMModelWrapper(LTHMModelConfig.from_dict(_tiny_config(seq)), device=dev)
    if n > 1:
        wrapper.bind_mesh(build_mesh(MeshConfig(data=n), device=str(dev)))
    state = TrainState.create(wrapper)
    batch = _batch(per_rank_batch, seq, seed=rank)
    offsets = [0, 1, 3]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    train_step(state, batch, offsets=offsets)  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        train_step(state, batch, offsets=offsets)
    sync()
    dt = time.perf_counter() - t0
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"seconds": dt}, f)
    if n > 1:
        dist.destroy_process_group()


def measure(n: int, per_rank_batch: int, seq: int, steps: int, device: str = "cuda") -> dict:
    """One rank count's throughput, ``n`` processes trained together: on the
    cards unless ``device="cpu"``; without a card it raises."""
    import socket

    import torch.multiprocessing as mp

    device = resolve_device(device).type

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        mp.start_processes(_rank, args=(n, port, device, per_rank_batch, seq, steps, out), nprocs=n,
                           start_method="spawn")
        with open(out) as f:
            dt = json.load(f)["seconds"]
    batch = n * per_rank_batch
    return {
        "ranks": n,
        "global_batch": batch,
        "examples_per_sec": steps * batch / dt,
        "examples_per_sec_per_rank": steps * batch / dt / n,
        "step_ms": dt / steps * 1e3,
        "regime": "nccl_one_card_a_rank" if device == "cuda" else "gloo_on_host_cores",
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    parser.add_argument("--per-rank-batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=32)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--device", default="cuda", help="cuda (one card a rank, NCCL) or cpu (gloo)")
    args = parser.parse_args(argv)
    sizes = list(args.ranks)
    if resolve_device(args.device).type == "cuda":
        sizes = [n for n in args.ranks if n <= torch.cuda.device_count()]
        dropped = [n for n in args.ranks if n not in sizes]
        if dropped:
            print(f"weak_scaling: skipping rank counts {dropped}: more than the {torch.cuda.device_count()} "
                  f"card(s) here", file=sys.stderr, flush=True)
    results = []
    for n in sizes:
        r = measure(n, args.per_rank_batch, args.seq, args.steps, args.device)
        results.append(r)
        print(json.dumps(r), flush=True)
    if results:
        base = results[0]["examples_per_sec_per_rank"]
        for r in results:
            r["weak_scaling_efficiency"] = r["examples_per_sec_per_rank"] / base
        on_cuda = args.device == "cuda"
        print(json.dumps({
            "metric": "weak_scaling_efficiency",
            "platform": "gpu" if on_cuda else "cpu",
            "device": torch.cuda.get_device_name(0) if on_cuda else "cpu",
            "note": ("one card a rank, NCCL: a real multi-device measurement" if on_cuda else
                     "gloo ranks share the host's cores - efficiency reflects host contention, not a network"),
            "series": {str(r["ranks"]): round(r["weak_scaling_efficiency"], 4) for r in results},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
