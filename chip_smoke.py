"""Smoke run of the PyTorch/CUDA port (``recommendations_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. device and build: the card, its power limit, and the flash-attention
     kernels (forward and backward) built by nvcc from the repo's sources,
     one nvcc per source, started together;
  2. each kernel against its plain PyTorch version on the card, at the
     serving and training shapes and at edge shapes, beside the stated
     tolerance;
  3. the serving path: the LTHM user encoder at the LTHM-base width
     (6 layers, d=512, MQA 32x16, context 256, a fresh 1M-row KShift table,
     random weights from a seed) answers 8 requests of 64 users; the launch
     counts show the path went through the kernel, the outputs are finite
     unit vectors, the kernel path agrees with the plain-attention path, and
     a small float32 model on the card agrees with the same weights on the CPU;
  4. the training path: the LTHM-base training step (fused_ce off, frozen
     table) takes a warm-up step and 8 timed steps on one batch of 64 users
     with fixed lookahead offsets; the launch counts show 6 flash_fwd and 6
     flash_bwd launches per step, the loss and gradient norm stay finite, no
     parameter turns NaN, the table stays as it was and the loss falls; one
     step's gradients on the kernel path agree with the plain-attention path,
     and a small float32 model's step on the card agrees with the CPU's;
  5. timing with CUDA events: each kernel, its plain version, one PyTorch
     library call for the same function as a yardstick, the request and the
     training step.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
card, and without the repo beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS_PER_S = 989e12  # dense tensor-core peak
F32_FLOPS_PER_S = 67e12    # outside the tensor cores
BATCH, EVENTS, CONTEXT = 64, 264, 256
REQUESTS = 8
TRAIN_STEPS = 8


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


def bwd_tolerance(dtype, ref) -> float:
    """f32: the JAX kernel tests' gradient tolerance, 2e-4 (absolute, and
    relative to each element). bf16: ds and p are rounded before the
    products and each output once, so a sum in another order may land on the
    neighbouring bf16 value: 2**-8 of the largest output."""
    if dtype == torch.float32:
        return 2e-4 + 2e-4 * ref.float().abs()
    return 2**-8 * max(1.0, ref.float().abs().max().item())


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


def flash_bwd_bound(b, t, n_head, hd, kvh, dtype, causal):
    """Least time for the backward call: q, dO, dq, k, v, dk, dv, lse and D
    each moved once, or five products (s, dp, dq, dk, dv) over the live
    pairs at the peak rate for their type."""
    el = torch.finfo(dtype).bits // 8
    nbytes = 3 * b * t * n_head * hd * el + 4 * b * t * kvh * hd * el + 2 * b * t * n_head * 4
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 5 * 2 * hd * n_head * b * pairs
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


def bwd_inputs(fa, b, t, n_head, hd, kvh, dtype, causal, seed):
    """q, k, v, o, lse from the forward kernel, and a cotangent dO."""
    q, k, v = randn_qkv(b, t, n_head, hd, kvh, dtype, seed)
    o, lse = fa.fused_flash_attention_fwd(q, k, v, n_head, causal)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    return q, k, v, o, lse, do


def compare_flash_bwd(fa, b, t, n_head, hd, kvh, dtype, causal, seed=0):
    q, k, v, o, lse, do = bwd_inputs(fa, b, t, n_head, hd, kvh, dtype, causal, seed)
    got = fa.fused_flash_attention_bwd(q, k, v, o, lse, do, n_head, causal)
    torch.cuda.synchronize()
    want = fa.fused_flash_attention_bwd_reference(q, k, v, o, lse, do, n_head, causal)
    errs, ok = [], True
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        tol = bwd_tolerance(dtype, w)
        ok &= bool(torch.isfinite(g.float()).all()) and bool((err <= tol).all())
        errs.append(err.max().item())
    tol_txt = "2e-4 abs + 2e-4 rel" if dtype == torch.float32 else f"{tol:.3e}"
    print(
        f"  flash_bwd B={b} T={t} H={n_head} hd={hd} kv_heads={kvh} {str(dtype)[6:]} "
        f"causal={causal}: max|err| dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} "
        f"(tol {tol_txt}) -> {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise AssertionError("flash_bwd disagrees with its plain version")
    return max(errs), (tol if dtype != torch.float32 else None)


def grads_of(wrapper, batch, aux, offsets):
    """One forward and backward of the training loss; (loss, {name: grad})."""
    wrapper.module.zero_grad(set_to_none=True)
    loss, _, _ = wrapper.loss_and_metrics(batch, aux, True, offsets=offsets)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in wrapper.module.named_parameters() if p.grad is not None}
    wrapper.module.zero_grad(set_to_none=True)
    return loss.item(), grads


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.ops import fused_attention as fa
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState

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
    kernels = (fa.FLASH_FWD, fa.FLASH_BWD)
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda kern: kern.build(), kernels))
    print(f"[1] built {', '.join(kern.source.name for kern in kernels)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for kern in kernels:
        for line in kern.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {kern.name}: " + line.strip(), flush=True)

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
    print("[2] flash_bwd against its plain version:", flush=True)
    bwd_err, bwd_tol = compare_flash_bwd(fa, *slice_shape)
    for shape in (
        (2, 70, 32, 16, 1, torch.bfloat16, True),
        (2, 450, 32, 16, 1, torch.bfloat16, True),     # the JAX two-kernel regime
        (2, 1100, 32, 16, 1, torch.bfloat16, True),    # the JAX grid regime
        (4, 257, 32, 16, 32, torch.bfloat16, True),    # MHA: FMA kernels
        (4, 257, 32, 16, 1, torch.float32, True),      # float32: FMA kernels
        (4, 257, 32, 16, 1, torch.bfloat16, False),    # non-causal
        (2, 300, 16, 32, 1, torch.bfloat16, True),     # tensor-core path, hd 32 and 64
        (2, 300, 16, 64, 1, torch.bfloat16, False),
        (2, 1100, 4, 16, 4, torch.float32, False),
    ):
        compare_flash_bwd(fa, *shape)

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

    # -- 4. the training path -------------------------------------------------
    del models, outs, seq, seq_plain
    torch.cuda.empty_cache()
    state = TrainState.create(wrapper, seed=1)
    table = wrapper.module.product_emb_module.embedding
    table_before = table.detach().clone()
    train_batch = request_batch(1000)
    offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
    first_loss, _ = train_step(state, train_batch, offsets=offsets)  # warm-up, step 1
    first_loss = first_loss.item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.FLASH_FWD.launches = fa.FLASH_BWD.launches = 0
    step_ms, losses, grad_norms, nans = [], [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, metrics = train_step(state, train_batch, offsets=offsets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        grad_norms.append(metrics["grad_norm"].item())
        nans.append(metrics["params_nan"].item())
    train_fwd, train_bwd = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches
    train_peak_mib = torch.cuda.max_memory_allocated() / 2**20
    print(f"[4] {TRAIN_STEPS} training steps of {BATCH} users (offsets {offsets.tolist()}): "
          f"flash_fwd launches {train_fwd}, flash_bwd launches {train_bwd} "
          f"(expected {layers} each per step)", flush=True)
    if train_fwd != layers * TRAIN_STEPS or train_bwd != layers * TRAIN_STEPS:
        raise AssertionError("the training step did not launch 6 flash_fwd and 6 flash_bwd per step")
    print(f"[4] loss: step 1 {first_loss:.5f}, steps 2-9 {[round(x, 5) for x in losses]}; "
          f"grad_norm {[round(x, 4) for x in grad_norms]}; params_nan {nans}", flush=True)
    if not all(np.isfinite(losses + grad_norms + [first_loss])) or any(nans):
        raise AssertionError("a training step gave a non-finite loss or gradient, or NaN parameters")
    if not torch.equal(table, table_before):
        raise AssertionError("the frozen product-embedding table changed")
    if not losses[-1] < first_loss:
        raise AssertionError("the loss did not fall over 8 steps on one batch")

    # one step's gradients: the kernel path against the plain-attention path
    loss_k, grads_k = grads_of(wrapper, train_batch, state.aux, offsets)
    with mock.patch.object(fa, "fused_flash_attention_fwd", fa.fused_flash_attention_reference), \
            mock.patch.object(fa, "fused_flash_attention_bwd", fa.fused_flash_attention_bwd_reference):
        before = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
        loss_p, grads_p = grads_of(wrapper, train_batch, state.aux, offsets)
        if (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches) != before:
            raise AssertionError("the plain-attention run launched a kernel")
    if set(grads_k) != set(grads_p) or "product_emb_module.embedding" in grads_k:
        raise AssertionError("the two paths gave gradients for different parameters")
    worst = max((rel_err(grads_k[n], grads_p[n]), n) for n in grads_p)
    # bf16 carries 8 significant bits; one-ulp flips in o, dq, dk and dv
    # travel through the 6 layers' bf16 products: each parameter's gradient
    # held at 2**-5 norm-relative (four ulps), the loss at 2**-8 relative
    grad_tol, loss_tol = 2**-5, 2**-8 * abs(loss_p)
    ok = worst[0] <= grad_tol and abs(loss_k - loss_p) <= loss_tol
    print(f"[4] one step's gradients, kernel vs plain attention: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (tol {loss_tol:.2e}); worst parameter {worst[1]} at norm-relative "
          f"{worst[0]:.3e} (tol {grad_tol:.3e}) over {len(grads_p)} parameters "
          f"-> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("kernel path and plain-attention path gradients disagree")
    del grads_k, grads_p

    # a small float32 model: one step on the card against one on the CPU
    train_small = dict(small, log_q_config={"num_buckets": 4096, "hash_offsets": [0, 7]},
                       train_mini_batch_size=3)
    small_cfg = LTHMModelConfig.from_dict(train_small)
    on_card = LTHMModelWrapper(small_cfg, device="cuda", seed=2)
    on_cpu = LTHMModelWrapper(small_cfg, device="cpu")
    on_cpu.module.load_state_dict({k: v.cpu() for k, v in on_card.module.state_dict().items()})
    sb = request_batch(98, batch=4, events=56)
    small_offsets = sample_offsets(torch.Generator().manual_seed(3), small_cfg.lookahead)
    results = []
    for w in (on_card, on_cpu):
        st = TrainState.create(w, seed=1)
        st.optimizer.zero_grad()
        loss_s, _, _ = w.loss_and_metrics(sb, st.aux, True, offsets=small_offsets)
        loss_s.backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in w.module.named_parameters() if p.grad is not None}
        st.optimizer.step()
        after = {n: p.detach().cpu() for n, p in w.module.named_parameters()}
        results.append((loss_s.item(), grads, after))
    (lc, gc, pc), (lp, gp, pp) = results
    # as the CPU parity tests hold the port to the JAX package: loss 1e-4,
    # gradients 2e-4 norm-relative, the cosine-LSH tables' gradient (a bf16
    # product in a float32 model) one bf16 ulp; the updated parameters 2e-4
    # norm-relative. (AdamW's first step is about lr * sign(g) per element,
    # so elements whose gradient is near eps carry the gradient's tiny
    # absolute difference into a full-size step difference: the steps
    # themselves are not compared element by element.)
    worst_g = max((rel_err(gc[n], gp[n]) / (2**-8 if ".direction_emb_" in n else 2e-4), n) for n in gp)
    worst_p = max((rel_err(pc[n], pp[n]) / 2e-4, n) for n in pp)
    ok = abs(lc - lp) <= 1e-4 and set(gc) == set(gp) and worst_g[0] <= 1 and worst_p[0] <= 1
    print(f"[4] small f32 model, one training step, card vs CPU: loss {lc:.6f} vs {lp:.6f}; "
          f"worst gradient {worst_g[1]} at {worst_g[0]:.3f} of its tolerance, worst updated "
          f"parameter {worst_p[1]} at {worst_p[0]:.3f} of its tolerance -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("the card and the CPU disagree on the small model's training step")

    # -- 5. timing ---------------------------------------------------------------
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
    print(f"[5] flash_fwd at B={b} T={t} MQA {h}x{hd} bf16 causal: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {flops} flop)", flush=True)

    # the backward kernel alone (D given, as the bound counts it), its plain
    # version, and the backward of scaled_dot_product_attention on expanded K/V
    q, k, v, o, lse, do = bwd_inputs(fa, b, t, h, hd, kvh, dt, causal, seed=8)
    dcol = fa._rowsum_do_o(do, o, h).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream().cuda_stream

    def bwd_kernel():
        fa.FLASH_BWD.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dcol.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, t, h, kvh, hd, int(causal), 1, stream,
        )

    bwd_ms = cuda_ms(bwd_kernel, 50)
    bwd_plain_ms = cuda_ms(lambda: fa.fused_flash_attention_bwd_reference(q, k, v, o, lse, do, h, causal), 5)
    qh = q.view(b, t, h, hd).transpose(1, 2).detach().requires_grad_()
    kh = k.view(b, t, 1, hd).transpose(1, 2).detach().requires_grad_()
    vh = v.view(b, t, 1, hd).transpose(1, 2).detach().requires_grad_()
    doh = do.view(b, t, h, hd).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qh, kh.expand(b, h, t, hd), vh.expand(b, h, t, hd), is_causal=True)

    def sdpa_fwd_bwd():
        out = sdpa(qh, kh.expand(b, h, t, hd), vh.expand(b, h, t, hd), is_causal=True)
        torch.autograd.grad(out, (qh, kh, vh), doh)

    bwd_library_ms = cuda_ms(sdpa_fwd_bwd, 30) - cuda_ms(sdpa_fwd, 30)
    bwd_bound_ms, bwd_bound_by, bwd_bytes, bwd_flops = flash_bwd_bound(b, t, h, hd, kvh, dt, causal)
    print(f"[5] flash_bwd at B={b} T={t} MQA {h}x{hd} bf16 causal: kernel {bwd_ms:.4f} ms, "
          f"plain {bwd_plain_ms:.4f} ms, scaled_dot_product_attention backward "
          f"{bwd_library_ms:.4f} ms, bound {bwd_bound_ms:.4f} ms ({bwd_bound_by}: {bwd_bytes} "
          f"bytes, {bwd_flops} flop)", flush=True)

    # the forward at T > 512 (the no-bias _fwd_kernel_grid's lengths)
    lb, lt = 16, 1025
    q, k, v = randn_qkv(lb, lt, h, hd, 1, dt, seed=9)
    long_ms = cuda_ms(lambda: fa.fused_flash_attention_fwd(q, k, v, h, True), 20)
    qh = q.view(lb, lt, h, hd).transpose(1, 2)
    kh = k.view(lb, lt, 1, hd).transpose(1, 2).expand(lb, h, lt, hd)
    vh = v.view(lb, lt, 1, hd).transpose(1, 2).expand(lb, h, lt, hd)
    long_library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True), 20)
    long_bound_ms, long_bound_by, _, _ = flash_bound(lb, lt, h, hd, 1, dt, True)
    print(f"[5] flash_fwd at B={lb} T={lt} MQA {h}x{hd} bf16 causal: kernel {long_ms:.4f} ms, "
          f"scaled_dot_product_attention {long_library_ms:.4f} ms, bound {long_bound_ms:.4f} ms "
          f"({long_bound_by})", flush=True)

    print(f"[5] user_encoder request ({BATCH} users): median {med:.3f} ms, "
          f"min {min(request_ms):.3f} ms, max {max(request_ms):.3f} ms; "
          f"{BATCH / (med / 1e3):.1f} users/s; peak device memory {peak_mib:.1f} MiB", flush=True)
    step_med = float(np.median(step_ms))
    print(f"[5] training step ({BATCH} users): median {step_med:.3f} ms, min {min(step_ms):.3f} ms, "
          f"max {max(step_ms):.3f} ms; {BATCH / (step_med / 1e3):.1f} examples/s; "
          f"peak device memory {train_peak_mib:.1f} MiB", flush=True)

    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "recommendations_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "recommendations_tpu/ops/fused_attention.py:193",
        "launches": train_fwd,
        "launches_per_step": train_fwd // TRAIN_STEPS,
        "launches_serving": launches,
        "launches_per_request": launches // REQUESTS,
        "max_abs_err": slice_err,
        "tolerance": slice_tol,
        "lse_max_abs_err": slice_lerr,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "t1025": {"ms": long_ms, "bound_ms": long_bound_ms, "bound_by": long_bound_by,
                  "library_ms": long_library_ms},
    }, {
        "name": "flash_bwd",
        "route": "cuda",
        "source": "recommendations_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "recommendations_tpu/ops/fused_attention.py:442",
        "launches": train_bwd,
        "launches_per_step": train_bwd // TRAIN_STEPS,
        "max_abs_err": bwd_err,
        "tolerance": bwd_tol,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": bwd_library_ms,
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
