"""Smoke run of the PyTorch/CUDA port (``recommendations_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. device and build: the card, its power limit, and the flash-attention
     kernel built by nvcc from the repo's sources;
  2. each kernel against its plain PyTorch version on the card, at the
     serving shape and at edge shapes, beside the stated tolerance;
  3. the serving path: the LTHM user encoder at the LTHM-base width
     (6 layers, d=512, MQA 32x16, context 256, a fresh 1M-row KShift table,
     random weights from a seed) answers 8 requests of 64 users; the launch
     counts show the path went through the kernel, the outputs are finite
     unit vectors, the kernel path agrees with the plain-attention path, and
     a small float32 model on the card agrees with the same weights on the CPU;
  4. timing with CUDA events: kernel, plain version, one PyTorch library call
     for the same function as a yardstick, and the request time.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
card, and without the repo beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # dense tensor-core peak
F32_FLOPS_PER_S = 67e12    # outside the tensor cores
BATCH, EVENTS, CONTEXT = 64, 264, 256
REQUESTS = 8


def bench_config() -> dict:
    """The LTHM-base shape bench.py builds for one chip."""
    d = 512
    return dict(
        features={"defaults": {}},
        compute_dtype="bfloat16",
        transformer_config=dict(
            rotator_config={"ff_mult": 4},
            is_causal=True,
            num_layers=6,
            enable_gradient_checkpointing=False,
            use_flash_attention=True,
            attn_config=dict(
                n_head=d // 16, n_embd=d, attn_type="multi_query",
                dropout=0.0, attn_dropout=0.0, bias=False,
            ),
        ),
        product_tower=dict(
            inp_emb_dim=32, out_emb_dim=d, product_emb_dim=128, norm_bins=20,
            cosine_lsh_config=[{"num_bins": nb, "num_proj": 32} for nb in (2, 4, 8, 12, 16, 20)],
            latent_model_config={
                "vocab_size_latent": 1_000_000, "num_shifts_latent": 8,
                "normalize_embedding": True,
            },
        ),
        log_q_config={"num_buckets": 2**22, "hash_offsets": [0, 34144, 7465477]},
        lookahead=[0, 5, 6, 12, 24, 30],
        context_width=CONTEXT,
        softmax_temperature=0.05,
        train_mini_batch_size=32,
        table_optimizer="frozen",
    )


def request_batch(seed: int, batch: int = BATCH, events: int = EVENTS) -> dict:
    """One request: ids drawn as bench.py draws them, the last 4 events padding."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(-(2**62), 2**62, size=(batch, events)).astype(np.int64)
    ids[:, -4:] = 0
    return {
        "product_ids": ids,
        "labels": rs.randint(0, 4, size=ids.shape).astype(np.float32),
        "timestamps": rs.randint(1_600_000_000, 1_700_000_000, size=ids.shape).astype(np.float32),
    }


def o_tolerance(dtype, o_ref) -> float:
    """f32: the JAX kernel tests' 2e-5. bf16: o is rounded to bf16 and p is
    rounded before the PV product, so a sum in another order may land on the
    neighbouring bf16 value: 2**-8 of the largest output."""
    if dtype == torch.float32:
        return 2e-5
    return 2**-8 * max(1.0, o_ref.float().abs().max().item())


LSE_TOL = 1e-4


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(b, t, n_head, hd, kvh, dtype, causal):
    """Least time for the call: bytes each read or written once over HBM
    rate, or the products' operations over the peak rate for their type."""
    el = torch.finfo(dtype).bits // 8
    nbytes = 2 * b * t * n_head * hd * el + 2 * b * t * kvh * hd * el + b * t * n_head * 4
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * hd * n_head * b * pairs
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def randn_qkv(b, t, n_head, hd, kvh, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, t, n_head * hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, t, kvh * hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, t, kvh * hd, generator=g, device="cuda").to(dtype)
    return q, k, v


def compare_flash(fa, b, t, n_head, hd, kvh, dtype, causal, seed=0):
    q, k, v = randn_qkv(b, t, n_head, hd, kvh, dtype, seed)
    o, lse = fa.fused_flash_attention_fwd(q, k, v, n_head, causal)
    torch.cuda.synchronize()
    ro, rl = fa.fused_flash_attention_reference(q, k, v, n_head, causal)
    err = (o.float() - ro.float()).abs().max().item()
    lerr = (lse - rl).abs().max().item()
    tol = o_tolerance(dtype, ro)
    ok = bool(torch.isfinite(o.float()).all()) and err <= tol and lerr <= LSE_TOL
    print(
        f"  flash_fwd B={b} T={t} H={n_head} hd={hd} kv_heads={kvh} {str(dtype)[6:]} "
        f"causal={causal}: o max|err| {err:.3e} (tol {tol:.3e}), "
        f"lse max|err| {lerr:.3e} (tol {LSE_TOL:.0e}) -> {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise AssertionError("flash_fwd disagrees with its plain version")
    return err, lerr, tol


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.ops import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    fa.FLASH_FWD.build()
    print(f"[1] built {fa.FLASH_FWD.source.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in fa.FLASH_FWD.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("    " + line.strip(), flush=True)

    # -- 2. kernel against its plain version -----------------------------------
    print("[2] flash_fwd against its plain version:", flush=True)
    slice_shape = (BATCH, CONTEXT + 1, 32, 16, 1, torch.bfloat16, True)
    slice_err, slice_lerr, slice_tol = compare_flash(fa, *slice_shape)
    for shape in (
        (2, 70, 32, 16, 1, torch.bfloat16, True),      # T not a multiple of anything
        (4, 257, 32, 16, 32, torch.bfloat16, True),    # MHA: kv heads = H
        (4, 257, 32, 16, 1, torch.bfloat16, False),    # non-causal
        (4, 257, 32, 16, 1, torch.float32, True),      # float32
        (2, 1100, 32, 16, 1, torch.bfloat16, True),    # T > 512: online softmax over chunks
        (2, 1100, 4, 16, 4, torch.float32, False),
        (2, 600, 16, 32, 1, torch.bfloat16, True),     # tensor-core path, hd 32 and 64:
        (2, 300, 16, 64, 1, torch.bfloat16, False),    # K/V restaged within a chunk
        (2, 96, 4, 16, 1, torch.bfloat16, True),       # MQA with 4 heads: FMA path
    ):
        compare_flash(fa, *shape)

    # -- 3. the serving path ---------------------------------------------------
    cfg = LTHMModelConfig.from_dict(bench_config())
    t0 = time.perf_counter()
    wrapper = LTHMModelWrapper(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in wrapper.module.parameters())
    print(f"[3] LTHM-base on {wrapper.device}: {n_params} parameters, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    models = wrapper.inference_models()
    requests = [request_batch(seed) for seed in range(1, REQUESTS + 1)]
    models["user_encoder"](request_batch(0))  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.FLASH_FWD.launches = 0
    request_ms, outs = [], []
    for batch in requests:
        t0 = time.perf_counter()
        out = models["user_encoder"](batch)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out["user_emb"])
    launches = fa.FLASH_FWD.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    layers = cfg.transformer_config.num_layers
    print(f"[3] {REQUESTS} requests of {BATCH} users: flash_fwd launches {launches} "
          f"(expected {layers} per request)", flush=True)
    if launches != layers * REQUESTS:
        raise AssertionError(f"flash_fwd launched {launches} times, expected {layers * REQUESTS}")
    for emb in outs:
        if tuple(emb.shape) != (BATCH, cfg.product_tower.product_emb_dim) or not emb.is_cuda:
            raise AssertionError(f"user_emb shape {tuple(emb.shape)} on {emb.device}")
        if not bool(torch.isfinite(emb).all()):
            raise AssertionError("user_emb is not finite")
        norm_err = (emb.norm(dim=-1) - 1).abs().max().item()
        if norm_err > 1e-4:
            raise AssertionError(f"user_emb is not unit-norm: {norm_err}")
    spread = max((a - b).abs().max().item() for a, b in zip(outs, outs[1:]))
    if spread == 0.0:
        raise AssertionError("all requests gave the same user vectors")
    print(f"[3] user_emb: finite, unit-norm, (64, 128) each; max |diff| between "
          f"requests {spread:.3f}", flush=True)

    # the kernel path against the same model with the plain attention version
    def plain_attention(q, k, v, n_head, causal=True):
        return fa.fused_flash_attention_reference(q, k, v, n_head, causal)[0]

    seq = models["sequence_encoder"](requests[0])
    with mock.patch.object(fa, "fused_flash_attention", plain_attention):
        before = fa.FLASH_FWD.launches
        seq_plain = models["sequence_encoder"](requests[0])
        if fa.FLASH_FWD.launches != before:
            raise AssertionError("the plain-attention run launched the kernel")
    w, g = seq_plain["next_token_emb"], seq["next_token_emb"]
    max_err, mean_err = (g - w).abs().max().item(), (g - w).abs().mean().item()
    # bf16 carries 8 significant bits; one-ulp flips inside a layer travel
    # through the 6 layers: held as the CPU parity tests hold bf16
    max_tol, mean_tol = 2**-6 * w.abs().max().item(), 2**-8 * w.abs().mean().item()
    ok = max_err <= max_tol and mean_err <= mean_tol
    print(f"[3] sequence_encoder, kernel vs plain attention: next_token_emb max|err| "
          f"{max_err:.3e} (tol {max_tol:.3e}), mean|err| {mean_err:.3e} (tol {mean_tol:.3e})"
          f" -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("kernel path and plain-attention path disagree")
    for k in seq:
        if seq[k].dtype.is_floating_point and not bool(torch.isfinite(seq[k]).all()):
            raise AssertionError(f"sequence_encoder {k} is not finite")

    # a small float32 model: the card (kernel) against the CPU (plain version)
    small = bench_config()
    small.update(compute_dtype="float32", context_width=48, lookahead=[0, 2, 4])
    small["transformer_config"].update(num_layers=2)
    small["transformer_config"]["attn_config"].update(n_head=4, n_embd=64)
    small["product_tower"].update(out_emb_dim=64, product_emb_dim=32, inp_emb_dim=16)
    small["product_tower"]["latent_model_config"]["vocab_size_latent"] = 5000
    small_cfg = LTHMModelConfig.from_dict(small)
    on_card = LTHMModelWrapper(small_cfg, device="cuda", seed=1)
    on_cpu = LTHMModelWrapper(small_cfg, device="cpu")
    on_cpu.module.load_state_dict({k: v.cpu() for k, v in on_card.module.state_dict().items()})
    sb = request_batch(99, batch=4, events=56)
    a = on_card.inference_models()["user_encoder"](sb)["user_emb"].cpu()
    b = on_cpu.inference_models()["user_encoder"](sb)["user_emb"]
    small_err = (a - b).abs().max().item()
    print(f"[3] small f32 model, card vs CPU: user_emb max|err| {small_err:.3e} (tol 1e-04)", flush=True)
    if small_err > 1e-4:
        raise AssertionError("the card and the CPU disagree on the small model")

    # -- 4. timing ---------------------------------------------------------------
    b, t, h, hd, kvh, dt, causal = slice_shape
    q, k, v = randn_qkv(b, t, h, hd, kvh, dt, seed=7)
    kernel_ms = cuda_ms(lambda: fa.fused_flash_attention_fwd(q, k, v, h, causal), 50)
    plain_ms = cuda_ms(lambda: fa.fused_flash_attention_reference(q, k, v, h, causal), 10)
    qh = q.view(b, t, h, hd).transpose(1, 2)
    kh = k.view(b, t, 1, hd).transpose(1, 2).expand(b, h, t, hd)
    vh = v.view(b, t, 1, hd).transpose(1, 2).expand(b, h, t, hd)
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=True), 50
    )
    bound_ms, bound_by, nbytes, flops = flash_bound(b, t, h, hd, kvh, dt, causal)
    med = float(np.median(request_ms))
    print(f"[4] flash_fwd at B={b} T={t} MQA {h}x{hd} bf16 causal: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {flops} flop)", flush=True)
    print(f"[4] user_encoder request ({BATCH} users): median {med:.3f} ms, "
          f"min {min(request_ms):.3f} ms, max {max(request_ms):.3f} ms; "
          f"{BATCH / (med / 1e3):.1f} users/s; peak device memory {peak_mib:.1f} MiB", flush=True)

    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "recommendations_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "recommendations_tpu/ops/fused_attention.py:193",
        "launches": launches,
        "launches_per_request": launches // REQUESTS,
        "max_abs_err": slice_err,
        "tolerance": slice_tol,
        "lse_max_abs_err": slice_lerr,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
