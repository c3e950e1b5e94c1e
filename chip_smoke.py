"""Smoke run of the PyTorch/CUDA port (``recommendations_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. device and build: the card, its power limit, and the kernels built by
     nvcc from the repo's sources (flash-attention forward and backward, each
     with its position-bias case, and the four fused contrastive-CE kernels),
     one nvcc per source, started together;
  2. each kernel against its plain PyTorch version on the card, at the
     serving and training shapes, the long-history shapes (B=16, T=1025;
     B=32, T=450: a block walks several tiles or items) and edge shapes
     (ragged last tiles, T=1), the CE kernels also at N = 16384 (context
     512), beside the stated tolerance, the plain
     versions over 4 batch rows at a time and each forward's (without and
     with the bias) at its kernel's own softmax arithmetic (16-key chunks
     and exp2 on the one-pass tensor-core kernels; the bias backward's p at
     the dQ kernel's exp2 where it takes it); every backward kernel (flash,
     bias, CE) and the bias forward also run twice for the same bits;
  3. the serving path: the LTHM user encoder at the LTHM-base width
     (6 layers, d=512, MQA 32x16, context 256, a fresh 1M-row KShift table,
     random weights from a seed) answers 8 requests of 64 users; the launch
     counts show the path went through the kernel, the outputs are finite
     unit vectors, the kernel path agrees with the plain-attention path, and
     a small float32 model on the card agrees with the same weights on the CPU;
     then the production LTHM (configs/model/lthm.yaml: 16 layers, remat, a
     relative-position bias, a fresh 10M-row table) at context 1024 answers 4
     requests of 64 users through the bias forward kernel (16 a request) and
     agrees with the plain bias attention;
  4. the training path as bench.py configures it (fused_ce on, frozen
     table): a warm-up step and 8 timed steps on one batch of 64 users with
     fixed lookahead offsets; the launch counts show 6 flash_fwd, 6 flash_bwd
     and 12 of each CE kernel per step, the loss and gradient norm stay
     finite, no parameter turns NaN, the table stays as it was and the loss
     falls; one step's gradients on the kernel path agree with the
     plain-attention path, with the plain CE path, and with the eager
     (fused_ce off) CE; the eager step then takes a warm-up and 4 timed
     steps (6 flash_fwd, 6 flash_bwd and 12 of each of the CE kernels'
     rounded case a step, none of the unrounded); a small float32
     model's step on the card agrees with the CPU's, with either CE; then the
     production model trains a warm-up and 3 timed steps of 64 users (16 of
     each bias kernel and 12 of each CE kernel a step, remat keeping the bias
     forward's outputs), its gradients (the position-bias tables' included)
     agree with the plain bias attention, and remat on and off give the same
     bits; then the long-history path of tools/bench_longseq.py (LTHM-base
     widths, remat, no position bias, context 1024, 16 users) answers 4
     requests (6 flash_fwd each) and trains a warm-up and 3 timed steps (6
     flash_fwd and 6 flash_bwd a step), with launch counts; then the
     trainable table (detach_item_tower false): LTHM-base (1M rows) with
     rowwise_adam, lazy_rowwise_adam and sparse_fused_adam forced, and the
     production LTHM at context 1024 (10M rows) with auto (which resolves to
     sparse_fused_adam, the fused (V, 128) record) and rowwise_adam, a
     warm-up and 3 timed steps each with launch counts, rows_nan folded into
     params_nan, the table rows that moved (only rows the batch's ids
     reach, and those of every real token the model reads); then the
     production LTHM at lthm.yaml's own context 512 (T = 513 = the bias
     window) answers 4 requests and trains a warm-up and 3 steps under the
     CUDA dispatch (the bias kernels at T == window), then one step under
     the JAX package's dispatch (_sdpa with the bias), the two dispatches'
     gradients on one state held to each other, peak memory of each; then
     the port's entry point, main_training, on configs/lthm_train.yaml (the
     production LTHM at context 512, eager CE, batch 64) with data from the
     port's synth_data in the in-memory store: 8 steps, 2 validation
     batches every 4 steps, a checkpoint and an export every 4 steps, a
     jsonl tracker; 16 of each bias kernel a step and 16 bias forwards a
     validation batch, the jsonl's lines under the JAX package's keys with
     finite losses, a second run resumed from the step-4 checkpoint ending
     on the same bits, the export serving the same user vectors in a fresh
     wrapper, and train_step called directly on the trained model; then
     main_training on lthm_train.yaml with every trainer knob (the fused CE,
     dropout 0.1 on q/k/v tokens and the residual branches, gradient
     accumulation 2, the spawned process reader, grouping by product_id
     under a shuffle buffer): 8 micro-steps at two steps a dispatch with a
     checkpoint (and the iterator snapshot) every 4 and profile capture over
     2 steps (16 of each bias kernel and of each CE kernel's count a step,
     the trace naming them), again at one step a dispatch (the same bits),
     and resumed from the step-4 snapshot (the same bits); the kernels held
     again to their plain versions on one layer's dropped-out q, k, v and one
     CE chunk of this model; the masks' keep rate within 4 binomial standard
     deviations of 0.9; remat on against off with dropout; debug_numerics on
     lthm_tiny (the clean loss unchanged, a planted NaN weight named by
     operation, a NaN kernel input named by kernel); then the MoE LTHM
     (lthm.yaml at context 512 with an MoE rotator: a gate layer of 128,
     top-2 of 4 experts of 256) serves 4 requests (16 bias forwards each) and
     trains a warm-up and 3 steps of 64 users (16 of each bias kernel and 12
     of each CE kernel a step), its gradients (the expert stacks and gates
     included) held to the plain bias attention, remat on and off the same
     bits, a small float32 MoE model on the card held to the CPU; then the
     long-history path with the sparse keep-sets (512 of 1025 positions a
     block) serves 4 requests and trains 3 steps of 16 users (6 flash_fwd
     and 6 flash_bwd a step, all at T = 512), its outputs and gradients held
     to the plain attention, the skipped positions x + null_connector(x);
     then main_training on configs/ranker_train.yaml (the factorized DLRM at
     ranker.yaml's widths, 20 steps of 256 cut from 200, validation and a
     checkpoint every 10, no kernel launched, and its batch inference: a
     score per validation impression), resumed from step 10 to the
     same bits, one step twice the same bits, the export reloaded and
     scoring the same, and a learning check to train AUC > 0.6; then the
     pipeline extras of configs/lthm_train.yaml at full width:
     main_training for 4 steps with the KNN eval (a parquet catalog of 1.5M
     string ids, two chunks of the running top-k merge), the batch
     inference and the traced export (16 bias forwards a step, a
     validation and a KNN query batch, and an inference batch through each
     of the two entry points), the KNN merge held to
     one full product and torch.topk on the card and its queries to the
     plain bias attention, the inference parquet to direct user_encoder
     calls bit for bit, the two .pt2 programs loaded in a fresh process that
     imports only recommendations_tpu_torch.ops (16 bias forwards a call, the
     eager bits), the compression job on 200000 128-wide vectors and
     lthm_train.yaml on its artifact serving and training a step with the
     frozen buffers untouched (main_training --config-name joint_train runs
     uncut in phase [7]);
  5. timing with CUDA events: each kernel, its plain version, its bound
     (and, as a note, the exponential floor of the bias and CE plane
     kernels), one PyTorch library call for the same function as a
     yardstick where there is one
     (the SDPA backward as profiler device time, beside its event time), the
     CE kernels at LTHM-base's chunk and at the production chunk (N = 32768),
     the eager CE on the CE kernels' problem, one attention layer on _sdpa
     with the bias against the fused bias path at T=513 and T=1025, and at
     T = window from 2 to 769 at B = 16 and 64 (the measurement behind the
     CUDA dispatch at T == window), the table updates alone, the requests and the
     training steps of every path, the trainer loop's step, its share
     waiting for the feed and its peak memory (also with every knob on), the
     MoE and sparse paths' requests and steps, flash_fwd and flash_bwd at the
     sparse path's T = 512, the ranker trainer's step, the pipeline extras'
     times (the KNN eval, the catalog encode, inference users/s, the
     export's trace and save, a .pt2 call against the eager request, the
     compression job's epochs), and the script's own seconds.

  6. the multi-device layers: two processes on the one card joined by a
     gloo group (NCCL refuses two ranks on one card; gloo moves every
     tensor through the host, so nothing here measures NCCL across cards)
     at full width: (a) data-parallel training of the production LTHM at
     context 512 (fused CE, frozen table), 2 x 32 users, step 1's loss and
     summed gradients held to one process's on the 64 users, a warm-up and
     3 steps (16 of each bias kernel and 6 of each CE kernel a rank and
     step), the same parameter bits on both ranks, the step's time and the
     gradient all-reduce's share; (b) lthm.yaml's 10M-row table at model =
     2, both schedules' forward and table gradient held to the dense
     lookup, the overflow count at capacity factor 0.05; (c) ring attention
     at MQA 32x16 with the bias window, T = 513 and 1025, held to the bias
     kernels; (d) the MoE LTHM at expert = 2 held to one process; then (e)
     (a)'s step through a one-rank NCCL group in this process. Each group
     has a 60 s timeout and the ranks a time limit.

  7. the runs QUALITY.md records, at their full length, through
     main_training, each metric's mean over seeds printed beside the JAX
     package's figure on the CPU (tools/quality_reference.py: mean and seed
     spread) and its band, the wider of twice that spread and a floor (0.02
     for a hit rate or an AUC, 2 positions, 0.2 for a loss); a miss fails
     the run: (a) lthm_tiny for 600 steps at seeds 0-2 (the port's weights
     from torch seed s, synth_data's click log from seed 100 s, 2 x 800
     users a date), the YAML as it stands (no kernel) and with flash
     attention and the fused CE (2 flash_fwd, 2 flash_bwd and 3 of each CE
     kernel a step, 2 flash_fwd, 3 ce_row_diag and 3 ce_fwd a validation
     batch, each run's totals checked, and one more train_step and one
     validation batch of each trained model counted alone; phase [2] holds
     each kernel to its plain version at these shapes), the kernel arm also
     held to the plain arm; (b) ranker_train
     at 400 steps (its 10 epochs end it at 320) at seeds 0-2; (c)
     joint_train uncut (4096 users, 6000 lthm_tiny steps, 10000 ranker
     steps an arm) at seed 0, the held-out-user AUC with the embeddings and
     the uplift over the ablated arm held to JAX's band, the uplift also
     within QUALITY.md's [0.08, 0.12].

Phase [7] runs right after [2], before the others: its loops are host-bound,
and in a process that had run phases [3]-[6] they took about 30% longer.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
card, and without the repo beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
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
EXP_PER_S = 16 * 132 * 1.98e9  # ex2 on the special-function units: 16 a clock per SM, 132 SMs, 1.98 GHz
BATCH, EVENTS, CONTEXT = 64, 264, 256
REQUESTS = 8
TRAIN_STEPS = 8
EAGER_STEPS = 4
PROD_REQUESTS = 4
PROD_STEPS = 3
PROD_CHECK_BATCH = 8  # users in the production path's checks against plain attention
TABLE_STEPS = 3  # timed steps of each trainable-table path
SWEEP_WINDOWS = (2, 17, 33, 65, 129, 257, 385, 513, 769)  # T = window of the bias sweep
INV_T = 20.0  # 1 / softmax_temperature


def bench_config() -> dict:
    """The LTHM-base shape and training settings bench.py builds for one
    chip (fused_ce=on_tpu: on an accelerator, the fused CE)."""
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
        fused_ce=True,
        table_optimizer="frozen",
    )


PROD_CONTEXT = 1024  # BASELINE config 5's history length
CTX512 = 512  # configs/model/lthm.yaml's own context_width


def production_config(context: int = PROD_CONTEXT) -> dict:
    """The production LTHM of configs/model/lthm.yaml (16 layers with remat,
    d=512, MQA 32x16, a relative-position bias, a 10M-row KShift table) at a
    long-history context: context_width ``context`` and a position-bias
    window of ``context + 1`` (with the CLS column), and fused_ce on, as
    bench.py sets it on an accelerator. Nothing else is changed."""
    import yaml

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "model", "lthm.yaml")
    with open(path) as f:
        d = yaml.safe_load(f)
    d["context_width"] = context
    d["transformer_config"]["attn_config"]["pos_bias"]["context_window"] = context + 1
    d["fused_ce"] = True
    return d


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


def device_ms(fn, iters: int = 10) -> float:
    """Device time per call: the kernels' time under torch.profiler, summed,
    over iters calls after one warm-up (the host's launch gaps excluded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()) / 1e3 / iters


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
    """The forward kernel against its plain version at the kernel's own
    softmax arithmetic (``kernel_softmax``), the plain version over 4 batch
    rows at a time; prints the K/V tiles the heaviest block walks."""
    q, k, v = randn_qkv(b, t, n_head, hd, kvh, dtype, seed)
    o, lse = fa.fused_flash_attention_fwd(q, k, v, n_head, causal)
    torch.cuda.synchronize()
    arith = fa.kernel_softmax(q, k, n_head)
    parts = [fa.fused_flash_attention_reference(q[i:i + 4], k[i:i + 4], v[i:i + 4], n_head, causal, **arith)
             for i in range(0, b, 4)]
    ro, rl = torch.cat([x[0] for x in parts]), torch.cat([x[1] for x in parts])
    err = (o.float() - ro.float()).abs().max().item()
    lerr = (lse - rl).abs().max().item()
    tol = o_tolerance(dtype, ro)
    ok = bool(torch.isfinite(o.float()).all()) and err <= tol and lerr <= LSE_TOL
    tiles = fa.block_walk(q, k, n_head)[0]
    walk = f"tensor cores, a block walks up to {tiles} K/V tiles" if tiles else "FMA kernel"
    print(
        f"  flash_fwd B={b} T={t} H={n_head} hd={hd} kv_heads={kvh} {str(dtype)[6:]} "
        f"causal={causal} ({walk}; plain at softmax chunk {arith['chunk']}, "
        f"{'exp2' if arith['exp2'] else 'exp'}): o max|err| {err:.3e} (tol {tol:.3e}), "
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
    """The backward kernels against their plain version (over 4 batch rows at
    a time, exp2 where the tensor-core kernels take it), run twice for the
    same bits; prints the items a dK/dV block walks."""
    q, k, v, o, lse, do = bwd_inputs(fa, b, t, n_head, hd, kvh, dtype, causal, seed)
    got = fa.fused_flash_attention_bwd(q, k, v, o, lse, do, n_head, causal)
    again = fa.fused_flash_attention_bwd(q, k, v, o, lse, do, n_head, causal)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(x, y) for x, y in zip(got, again))
    exp2 = fa.kernel_softmax(q, k, n_head)["exp2"]
    parts = [fa.fused_flash_attention_bwd_reference(q[i:i + 4], k[i:i + 4], v[i:i + 4], o[i:i + 4], lse[i:i + 4],
                                                    do[i:i + 4], n_head, causal, exp2=exp2) for i in range(0, b, 4)]
    want = [torch.cat([x[j] for x in parts]) for j in range(3)]
    errs, ok = [], same_bits
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        tol = bwd_tolerance(dtype, w)
        ok &= bool(torch.isfinite(g.float()).all()) and bool((err <= tol).all())
        errs.append(err.max().item())
    tol_txt = "2e-4 abs + 2e-4 rel" if dtype == torch.float32 else f"{tol:.3e}"
    items = fa.block_walk(q, k, n_head)[1]
    walk = f"tensor cores, a dK/dV block walks up to {items} items" if items else "FMA kernels"
    print(
        f"  flash_bwd B={b} T={t} H={n_head} hd={hd} kv_heads={kvh} {str(dtype)[6:]} "
        f"causal={causal} ({walk}): max|err| dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} "
        f"(tol {tol_txt}); same bits twice {same_bits} -> {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise AssertionError("flash_bwd disagrees with its plain version")
    return max(errs), (tol if dtype != torch.float32 else None)


def bias_reference(fa, q, k, v, table, o, lse, do, n_head, nk, causal, chunk):
    """The plain bias forward (at the forward kernel's own softmax
    arithmetic, ``bias_kernel_softmax``) and backward (p as the dQ kernel
    takes it, the same ``exp2``), over ``chunk`` batch rows at a time (their
    (B, H, T, T) f32 planes take 0.5 GB per 4 rows at T = 1025, H = 32): o,
    lse, dq, dk and dv concatenated, the table gradients summed."""
    arith = fa.bias_kernel_softmax(q, k, n_head)
    fwd, bwd = [], []
    for i in range(0, q.shape[0], chunk):
        rows = slice(i, i + chunk)
        fwd.append(fa.fused_flash_attention_bias_reference(q[rows], k[rows], v[rows], table, n_head, nk, causal,
                                                           **arith))
        bwd.append(fa.fused_flash_attention_bias_bwd_reference(
            q[rows], k[rows], v[rows], table, o[rows], lse[rows], do[rows], n_head, nk, causal,
            exp2=arith["exp2"]))
    ro, rl = (torch.cat([f[j] for f in fwd]) for j in range(2))
    grads = [torch.cat([g[j] for g in bwd]) for j in range(3)]
    return ro, rl, grads + [torch.stack([g[3] for g in bwd]).sum(0)]


def compare_flash_bias(fa, b, t, n_head, hd, kvh, dtype, causal, nk, seed=0, ref_chunk=4, inputs=None):
    """The three bias kernels (forward, dQ, dK/dV with the table gradient)
    against their plain versions (over ``ref_chunk`` batch rows at a time) on
    one input whose table entries are not bf16 values (so the kernels'
    rounding of the table shows), and run twice for the same bits; returns
    {kernel: (max error, tolerance)}. Prints the (key block, batch row) items
    a block of the persistent dK/dV grid walks: more than one where the items
    exceed what one wave of blocks holds. ``inputs``: (q, k, v, table) to
    hold them on, in place of random ones."""
    q, k, v = randn_qkv(b, t, n_head, hd, kvh, dtype, seed) if inputs is None else inputs[:3]
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    table = torch.randn(2 * nk + 1, n_head, generator=g, device="cuda") if inputs is None else inputs[3]
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    o, lse = fa.fused_flash_attention_bias_fwd(q, k, v, table, n_head, nk, causal)
    got = fa.fused_flash_attention_bias_bwd(q, k, v, table, o, lse, do, n_head, nk, causal)
    again = fa.fused_flash_attention_bias_fwd(q, k, v, table, n_head, nk, causal)
    again += fa.fused_flash_attention_bias_bwd(q, k, v, table, *again, do, n_head, nk, causal)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(x, y) for x, y in zip((o, lse, *got), again))
    ro, rl, want = bias_reference(fa, q, k, v, table, o, lse, do, n_head, nk, causal, ref_chunk)
    per_block = fa.bias_dkv_items_per_block(q, k, n_head)
    arith = fa.bias_kernel_softmax(q, k, n_head)
    out = {"flash_bias_fwd": ((o.float() - ro.float()).abs().max().item(), o_tolerance(dtype, ro))}
    lerr = (lse - rl).abs().max().item()
    ok = bool(torch.isfinite(o.float()).all()) and out["flash_bias_fwd"][0] <= out["flash_bias_fwd"][1]
    ok &= lerr <= LSE_TOL
    errs = []
    for gv, wv in zip(got[:3], want[:3]):
        # bf16: one bf16 ulp of the largest element (a sum in another order
        # may land on the neighbouring bf16 value); f32: 2e-4 abs + 2e-4 rel
        err = (gv.float() - wv.float()).abs()
        tol = bf16_ulp(wv) if dtype == torch.bfloat16 else bwd_tolerance(dtype, wv)
        ok &= bool(torch.isfinite(gv.float()).all()) and bool((err <= tol).all())
        errs.append((err.max().item(), tol if dtype != torch.float32 else None))
    # the table gradient: f32 sums of the unrounded ds in another order
    t_err = (got[3] - want[3]).abs().max().item()
    t_tol = 2e-4 * max(1.0, want[3].abs().max().item())
    ok &= bool(torch.isfinite(got[3]).all()) and t_err <= t_tol and same_bits
    out["flash_bias_dq"] = errs[0]
    out["flash_bias_dkv"] = max(errs[1], errs[2], key=lambda et: et[0] / (et[1] or 1.0))
    out["dtable"] = (t_err, t_tol)
    grads = ", ".join(
        f"{n} {e:.3e} (tol {'2e-4 abs + 2e-4 rel' if tl is None else f'{tl:.3e}'})"
        for n, (e, tl) in zip(("dq", "dk", "dv"), errs))
    print(
        f"  flash_bias B={b} T={t} H={n_head} hd={hd} kv_heads={kvh} {str(dtype)[6:]} causal={causal} "
        f"nk={nk} (a dK/dV block walks up to {per_block} items{'' if per_block else ': FMA kernels'}; forward "
        f"held at softmax chunk {arith['chunk']}, the forward and backward at "
        f"{'exp2' if arith['exp2'] else 'exp'}): "
        f"o {out['flash_bias_fwd'][0]:.3e} (tol {out['flash_bias_fwd'][1]:.3e}), lse {lerr:.3e} "
        f"(tol {LSE_TOL:.0e}); {grads}; "
        f"dtable {t_err:.3e} (tol {t_tol:.3e}); same bits twice {same_bits} -> {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise AssertionError("a flash bias kernel disagrees with its plain version")
    return out


def flash_bias_bound(kernel, b, t, n_head, hd, kvh, dtype, causal, n_table):
    """Least time for one bias kernel call: its inputs read and outputs
    written once over HBM rate (the table (n_table, H) f32 read, and for
    the dK/dV kernel the table gradient written), or its products over the
    live pairs at the peak rate: forward s and pv; dQ s, dp, dq; dK/dV s, dp,
    dv, dk."""
    el = torch.finfo(dtype).bits // 8
    qb, kb, rb, tb = b * t * n_head * hd * el, b * t * kvh * hd * el, b * t * n_head * 4, n_table * n_head * 4
    nbytes, products = {
        "flash_bias_fwd": (2 * qb + 2 * kb + rb + tb, 2),
        "flash_bias_dq": (3 * qb + 2 * kb + 2 * rb + tb, 3),
        "flash_bias_dkv": (2 * qb + 4 * kb + 2 * rb + 2 * tb, 4),
    }[kernel]
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = products * 2 * hd * n_head * b * pairs
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def bf16_ulp(ref) -> float:
    """One bf16 ulp of the largest element of ref: 2**(e - 7) for the
    largest magnitude in [2**e, 2**(e+1))."""
    top = ref.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


CE_TOL = 2e-5    # ce, lse and diag: f32, absolute plus relative (the JAX kernel tests')
TIE_EPS = 1e-4   # logits this close to the positive's may rank either way


def ce_inputs(n, s, d, pattern, seed=0, grid=False):
    """Unit bf16 rows, validity and logQ as the loss makes them. pattern:
    'roll' the last 4 slots of every user invalid (the padding of a request,
    rolled by offset 0); 'random' 10% invalid; 'invalid_user' as random with
    user 2 all invalid; 'one_user' only user 1 valid but for one slot, so
    every other row has no valid column and that slot's row is fully masked
    (ce = -inf). grid: every element of a row also a multiple of 2**-10, so
    every partial sum of a product q_i.c_j is exact in float32 and S, and
    its bf16 rounding, is the same in any order of summation (the rounded
    case's inputs)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def unit():
        x = torch.nn.functional.normalize(torch.randn(n, d, generator=g, device="cuda"), dim=-1).bfloat16()
        return (torch.round(x.float() * 1024.0) / 1024.0).bfloat16() if grid else x

    q, c = unit(), unit()
    slot = torch.arange(n, device="cuda") % s
    if pattern == "roll":
        v = slot < s - 4
    else:
        v = torch.rand(n, generator=g, device="cuda") >= 0.1
    if pattern == "invalid_user":
        v[2 * s: 3 * s] = False
    if pattern == "one_user":
        v[:] = False
        v[s: 2 * s - 1] = True
    lq = -torch.log(torch.rand(n, generator=g, device="cuda") * 1e4 + 1.0)  # logQ-sized, in [-9.2, 0]
    dce = torch.rand(n, generator=g, device="cuda") * v  # zero weight on invalid rows, as the loss
    return q, c, v, lq, dce


def compare_ce(fc, n, s, d, beta, pattern, inputs=None, rounded=False):
    """Each CE kernel against its plain version on one input (random, or
    ``inputs``: (q, c, v, lq), with a random cotangent); returns the errors
    of the four kernels and their tolerances. ``rounded``: the rounded case's
    kernels against the rounded plain versions, on grid rows (``ce_inputs``)
    unless ``inputs`` are given."""
    q, c, v, lq, dce = ce_inputs(n, s, d, pattern, seed=n + d, grid=rounded)
    if inputs is not None:
        q, c, v, lq = inputs
    row_diag_kernel = fc.CE_ROW_DIAG_ROUNDED if rounded else fc.CE_ROW_DIAG
    ce, rank, lse = fc.ce_forward(q, c, v, lq, s, INV_T, beta, rounded)
    dq, dc = fc.ce_backward(q, c, v, lq, lse, dce, s, INV_T, beta, rounded)
    torch.cuda.synchronize()
    again = (fc.ce_forward(q, c, v, lq, s, INV_T, beta, rounded)
             + fc.ce_backward(q, c, v, lq, lse, dce, s, INV_T, beta, rounded))
    # ce_row_diag alone, twice: diag and the shift m
    pair = []
    for _ in range(2):
        diag_k, m_k = torch.empty_like(ce), torch.empty((), device="cuda")
        row_diag_kernel.launch(q.data_ptr(), c.data_ptr(), v.data_ptr(), lq.data_ptr(), diag_k.data_ptr(),
                               m_k.data_ptr(), n, d, INV_T, beta, torch.cuda.current_stream().cuda_stream)
        pair.append((diag_k, m_k))
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip((ce, rank, lse, dq, dc, *pair[0]), again + pair[1]))
    diag, m = fc.row_diag_and_shift_reference(q, c, v, lq, INV_T, beta, rounded)
    m_bits = torch.equal(m_k.view(torch.int32), m.view(torch.int32))
    rce, rrank, rlse = fc.ce_fwd_reference(q, c, v, lq, diag, s, INV_T, beta, rounded)
    rdq = fc.ce_grad_reference(q, c, v, lq, rlse, dce, s, INV_T, beta, "q", rounded)
    rdc = fc.ce_grad_reference(q, c, v, lq, rlse, dce, s, INV_T, beta, "c", rounded)

    def f32_err(got, want):
        fin = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), fin) or not torch.equal(got[~fin], want[~fin]):
            return float("inf")
        return ((got - want).abs() / (1.0 + want.abs()))[fin].max().item() if fin.any() else 0.0

    errs = {"ce_row_diag": f32_err(diag_k, diag), "ce_fwd": max(f32_err(ce, rce), f32_err(lse, rlse))}
    # rank: equal but where an off-diagonal live logit lies within TIE_EPS of diag
    logits, _, eye = fc._masked_plane(q, c, v, lq, s, INV_T, beta, rounded)
    near = (((logits - diag[:, None]).abs() <= TIE_EPS) & ~eye & (logits > -1e8)).any(-1)
    differ = rank != rrank
    unexplained = int((differ & ~near).sum())
    del logits, eye
    ok = errs["ce_row_diag"] <= CE_TOL and m_bits and errs["ce_fwd"] <= CE_TOL and unexplained == 0
    tols = {"ce_row_diag": CE_TOL, "ce_fwd": CE_TOL}
    for name, got, want in (("ce_dq", dq, rdq), ("ce_dc", dc, rdc)):
        err = (got.float() - want.float()).abs().max().item()
        # one bf16 ulp of the largest; where the gradient vanishes (rows whose
        # only live column is their own: p_ii = 1 up to the rounding of lse)
        # both hold that rounding times dce * inv_t, a floor of 2**-16 * inv_t
        tols[name] = max(bf16_ulp(want), 2**-16 * INV_T)
        errs[name] = err
        ok &= bool(torch.isfinite(got.float()).all()) and err <= tols[name]
    ok &= same_bits
    print(
        f"  fused CE{' rounded' if rounded else ''} N={n} s={s} D={d} beta={beta} {pattern}: "
        f"diag {errs['ce_row_diag']:.2e}, "
        f"m {m_k.item()!r} (plain {m.item()!r}, bit-equal {m_bits}), "
        f"ce/lse {errs['ce_fwd']:.2e} (tol {CE_TOL:.0e} abs + rel); rank differs on "
        f"{int(differ.sum())} rows, {int(near.sum())} rows have a logit within {TIE_EPS:.0e} of "
        f"the positive's, {unexplained} differ otherwise; dq {errs['ce_dq']:.3e} "
        f"(tol {tols['ce_dq']:.3e}), dc {errs['ce_dc']:.3e} (tol {tols['ce_dc']:.3e}); "
        f"{int((~torch.isfinite(ce)).sum())} rows -inf; same bits twice {same_bits} "
        f"-> {'ok' if ok else 'FAIL'}",
        flush=True,
    )
    if not ok:
        raise AssertionError("a fused CE kernel disagrees with its plain version")
    return errs, tols


def ce_bound(kernel, n, d):
    """Least time for one call at (N, D), bf16 rows: its inputs read and
    outputs written once over HBM rate, or its products at the peak rate
    (the row dot on the f32 units, the tiles' products on the tensor cores)."""
    rows = 2 * n * d * 2 + n  # q, c, v
    if kernel == "ce_row_diag":  # lq read, diag and m written
        nbytes, flops, peak = rows + 4 * n + 4 * n + 4, 2 * n * d, F32_FLOPS_PER_S
    elif kernel == "ce_fwd":
        nbytes, flops, peak = rows + 2 * 4 * n + 4 + 3 * 4 * n, 2 * n * n * d, BF16_FLOPS_PER_S
    else:  # ce_dq, ce_dc: S and the gradient product
        nbytes, flops, peak = rows + 3 * 4 * n + n * d * 2, 4 * n * n * d, BF16_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ce(fc, n, s, d, beta, plain_iters=5, rounded=False):
    """Each CE kernel alone at (N, D) with s tokens a user, its inputs ready,
    its plain version, its bound and the nearest single PyTorch call: for
    ``ce_row_diag`` ``torch.linalg.vecdot`` of the bf16 rows, which returns
    bf16 and forms no shift (a yardstick, not the same function); none
    computes the plane kernels' function. ``ce_row_diag``'s and its library
    call's ms are device time under the profiler. ``rounded``: the rounded
    case's kernels and plain versions (the same bounds). Returns {kernel:
    numbers}."""
    q, c, v, lq, dce = ce_inputs(n, s, d, "roll", seed=12)
    stream = torch.cuda.current_stream().cuda_stream
    row_diag_k, fwd_k, dq_k, dc_k = fc.ROUNDED_KERNELS if rounded else fc.KERNELS
    diag, m = fc.row_diag_and_shift_reference(q, c, v, lq, INV_T, beta, rounded)
    ce, rank, lse = (torch.empty_like(diag), torch.empty(n, dtype=torch.int32, device="cuda"),
                     torch.empty_like(diag))
    grad = torch.empty_like(q)
    ptrs = (q.data_ptr(), c.data_ptr(), v.data_ptr(), lq.data_ptr())
    launch = {
        "ce_row_diag": lambda: row_diag_k.launch(
            *ptrs, diag.data_ptr(), m.data_ptr(), n, d, INV_T, beta, stream),
        "ce_fwd": lambda: fwd_k.launch(
            *ptrs, m.data_ptr(), diag.data_ptr(), ce.data_ptr(), lse.data_ptr(), rank.data_ptr(),
            n, d, s, INV_T, beta, stream),
        "ce_dq": lambda: dq_k.launch(
            *ptrs, lse.data_ptr(), dce.data_ptr(), grad.data_ptr(), n, d, s, INV_T, beta, stream),
        "ce_dc": lambda: dc_k.launch(
            *ptrs, lse.data_ptr(), dce.data_ptr(), grad.data_ptr(), n, d, s, INV_T, beta, stream),
    }
    plain = {
        "ce_row_diag": lambda: fc.row_diag_and_shift_reference(q, c, v, lq, INV_T, beta, rounded),
        "ce_fwd": lambda: fc.ce_fwd_reference(q, c, v, lq, diag, s, INV_T, beta, rounded),
        "ce_dq": lambda: fc.ce_grad_reference(q, c, v, lq, lse, dce, s, INV_T, beta, "q", rounded),
        "ce_dc": lambda: fc.ce_grad_reference(q, c, v, lq, lse, dce, s, INV_T, beta, "c", rounded),
    }
    launch["ce_row_diag"]()
    launch["ce_fwd"]()
    times = {}
    for name in launch:
        bound, by = ce_bound(name, n, d)
        times[name] = {"ms": cuda_ms(launch[name], 50 if n <= 8192 else 10),
                       "plain_ms": cuda_ms(plain[name], plain_iters, warmup=1),
                       "bound_ms": bound, "bound_by": by, "library_ms": None}
        how, floor, library = "", "", "none"
        if name == "ce_row_diag":
            # a loop of its launches from Python is host-bound (about 0.012 ms
            # a launch at either N): the kernel's and the library call's ms
            # are their device time under the profiler; the loop's is kept
            times[name]["loop_ms"] = times[name]["ms"]
            times[name]["ms"] = device_ms(launch[name], 50)
            times[name]["library_ms"] = device_ms(lambda: torch.linalg.vecdot(q, c), 50)
            how = f" (device time; a loop of launches {times[name]['loop_ms']:.4f} ms)"
            library = (f"torch.linalg.vecdot {times[name]['library_ms']:.4f} ms device time (bf16 out, no "
                       "shift: a yardstick)")
        else:  # a note beside the bound, printed only: one exponential per logit
            floor = f", exponential floor {n * n / EXP_PER_S * 1e3:.4f} ms (a note: one ex2 per logit)"
        torch.cuda.empty_cache()
        print(f"[5] {name}{' rounded' if rounded else ''} at N={n} D={d} s={s} beta={beta}: kernel "
              f"{times[name]['ms']:.4f} ms{how}, plain "
              f"{times[name]['plain_ms']:.4f} ms, bound {bound:.4f} ms ({by}){floor}; library {library}",
              flush=True)
    return times


def grads_of(wrapper, batch, aux, offsets, dropout_seed=None):
    """One forward and backward of the training loss; (loss, {name: grad})."""
    wrapper.module.zero_grad(set_to_none=True)
    loss, _, _ = wrapper.loss_and_metrics(batch, aux, True, offsets=offsets, dropout_seed=dropout_seed)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in wrapper.module.named_parameters() if p.grad is not None}
    wrapper.module.zero_grad(set_to_none=True)
    return loss.item(), grads


def rel_err(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def held_to(label, other, grads_k, loss_k, grad_tol, loss_tol, why):
    """One step's gradients on the kernel path against another path's:
    every parameter's norm-relative error and the loss, at the stated
    tolerances; returns the worst error."""
    loss_o, grads_o = other
    if set(grads_k) != set(grads_o) or "product_emb_module.embedding" in grads_k:
        raise AssertionError(f"{label}: the two paths gave gradients for different parameters")
    worst = max((rel_err(grads_k[n], grads_o[n]), n) for n in grads_o)
    ok = worst[0] <= grad_tol and abs(loss_k - loss_o) <= loss_tol
    print(f"[4] one step's gradients, {label}: loss {loss_k:.6f} vs {loss_o:.6f} (tol "
          f"{loss_tol:.2e}); worst parameter {worst[1]} at norm-relative {worst[0]:.3e} "
          f"(tol {grad_tol:.3e}) over {len(grads_o)} parameters; {why} "
          f"-> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: gradients disagree")
    return worst[0]


def train_production(fa, fc, kernels, wrapper):
    """Phase [4] on the production path (fused_ce on, remat dots_no_batch,
    frozen table): a warm-up step and PROD_STEPS timed steps of 64 users on
    one batch with fixed lookahead offsets, every launch count set to 0 just
    before the timed steps and read just after; finite loss and gradient
    norm, no NaN parameter, the table as it was, the loss falling; one step's
    gradients at PROD_CHECK_BATCH users against the plain bias attention, and
    remat on against remat off. Returns numbers for phase [5]."""
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState

    cfg = wrapper.config
    layers = cfg.transformer_config.num_layers
    heads, chunks = len(cfg.lookahead), BATCH // cfg.train_mini_batch_size
    state = TrainState.create(wrapper, seed=1)
    table = wrapper.module.product_emb_module.embedding
    table_before = table.detach().clone()
    events = PROD_CONTEXT + 8
    batch = request_batch(2000, BATCH, events)
    offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
    first_loss = train_step(state, batch, offsets=offsets)[0].item()  # warm-up, step 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    step_ms, losses, grad_norms, nans = [], [], [], []
    for _ in range(PROD_STEPS):
        t0 = time.perf_counter()
        loss, metrics = train_step(state, batch, offsets=offsets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        grad_norms.append(metrics["grad_norm"].item())
        nans.append(metrics["params_nan"].item())
    counts = {kern.name: kern.launches for kern in kernels}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    # remat keeps the bias forward's (o, lse) (dots_no_batch): no second launch
    want = {kern.name: 0 for kern in kernels}
    want.update({"flash_bias_fwd": layers, "flash_bias_dq": layers, "flash_bias_dkv": layers,
                 **{kern.name: heads * chunks for kern in fc.KERNELS}})
    print(f"[4] {PROD_STEPS} production training steps of {BATCH} users ({events} events, fused_ce on, "
          f"remat {cfg.transformer_config.remat_policy}): launches {counts} (expected per step {want})",
          flush=True)
    if counts != {k: n * PROD_STEPS for k, n in want.items()}:
        raise AssertionError("the production step did not launch each kernel of its path as expected")
    print(f"[4] production loss: step 1 {first_loss:.5f}, steps 2-{PROD_STEPS + 1} "
          f"{[round(x, 5) for x in losses]}; grad_norm {[round(x, 4) for x in grad_norms]}; "
          f"params_nan {nans}", flush=True)
    if not all(np.isfinite(losses + grad_norms + [first_loss])) or any(nans):
        raise AssertionError("a production step gave a non-finite loss or gradient, or NaN parameters")
    if not torch.equal(table, table_before):
        raise AssertionError("the frozen product-embedding table changed")
    if not losses[-1] < first_loss:
        raise AssertionError(f"the production loss did not fall over {PROD_STEPS + 1} steps on one batch")

    # one step's gradients at PROD_CHECK_BATCH users: the kernels against the
    # plain bias attention, and remat on against remat off
    check = request_batch(2001, PROD_CHECK_BATCH, events)
    loss_k, grads_k = grads_of(wrapper, check, state.aux, offsets)
    before = [kern.launches for kern in kernels]
    with mock.patch.object(fa, "fused_flash_attention_bias_fwd", fa.fused_flash_attention_bias_reference), \
            mock.patch.object(fa, "fused_flash_attention_bias_bwd", fa.fused_flash_attention_bias_bwd_reference):
        plain = grads_of(wrapper, check, state.aux, offsets)
    if [kern.launches for kern in kernels[:5]] != before[:5]:
        raise AssertionError("the plain bias attention run launched a flash kernel")
    if not any(n.endswith("pos_bias.bias") for n in grads_k):
        raise AssertionError("no gradient reached the position-bias tables")
    plain_err = held_to(
        "production, kernel vs plain bias attention", plain, grads_k, loss_k, 2**-5, 2**-8 * abs(loss_k),
        f"one-ulp flips in o, dq, dk, dv travel through {layers} layers of bf16 products: 2**-5 (four "
        "ulps), the loss 2**-8 relative; the position-bias tables included")
    del plain
    stack = wrapper.module.query_tower.transformer
    stack.remat = False
    off = grads_of(wrapper, check, state.aux, offsets)
    stack.remat = True
    same = off[0] == loss_k and all(torch.equal(grads_k[n], off[1][n]) for n in grads_k)
    print(f"[4] production, remat on vs off: loss {loss_k:.6f} vs {off[0]:.6f}, every gradient the same "
          f"bits {same} -> {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError("remat changed the gradients")
    return {"step_ms": step_ms, "peak_mib": peak_mib, "counts": counts, "plain_err": plain_err}


def serve_production(fa, kernels):
    """Phase [3] on the production path: the production LTHM at context 1024
    answers a warm-up and PROD_REQUESTS requests of 64 users, with every
    launch count set to 0 just before the requests and read just after (16
    bias forwards a request, nothing else); the user vectors are finite unit
    vectors; a request of PROD_CHECK_BATCH users agrees with the same model
    with the plain bias attention. Returns (wrapper, numbers)."""
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper

    cfg = LTHMModelConfig.from_dict(production_config())
    layers = cfg.transformer_config.num_layers
    t0 = time.perf_counter()
    wrapper = LTHMModelWrapper(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in wrapper.module.parameters())
    print(f"[3] production LTHM (configs/model/lthm.yaml: {layers} layers, remat "
          f"{cfg.transformer_config.remat_policy}, position bias window "
          f"{cfg.transformer_config.attn_config.pos_bias.context_window}, context {cfg.context_width}) on "
          f"{wrapper.device}: {n_params} parameters, built in {time.perf_counter() - t0:.2f} s", flush=True)
    models = wrapper.inference_models()
    events = PROD_CONTEXT + 8
    models["user_encoder"](request_batch(100, BATCH, events))  # warm-up
    requests = [request_batch(seed, BATCH, events) for seed in range(101, 101 + PROD_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    request_ms, outs = [], []
    for batch in requests:
        t0 = time.perf_counter()
        out = models["user_encoder"](batch)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out["user_emb"])
    counts = {kern.name: kern.launches for kern in kernels}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    want = {kern.name: (layers * PROD_REQUESTS if kern is fa.FLASH_BIAS_FWD else 0) for kern in kernels}
    print(f"[3] {PROD_REQUESTS} production requests of {BATCH} users ({events} events): launches "
          f"{counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError("the production requests did not launch the bias forward once a layer")
    for emb in outs:
        if tuple(emb.shape) != (BATCH, cfg.product_tower.product_emb_dim) or not bool(torch.isfinite(emb).all()):
            raise AssertionError(f"production user_emb: shape {tuple(emb.shape)} or not finite")
        if (emb.norm(dim=-1) - 1).abs().max().item() > 1e-4:
            raise AssertionError("production user_emb is not unit-norm")

    def plain_bias(q, k, v, table, n_head, nk, causal=True):
        return fa.fused_flash_attention_bias_reference(q, k, v, table, n_head, nk, causal)[0]

    check = request_batch(150, PROD_CHECK_BATCH, events)
    seq = models["sequence_encoder"](check)
    before = fa.FLASH_BIAS_FWD.launches
    with mock.patch.object(fa, "fused_flash_attention_bias", plain_bias):
        seq_plain = models["sequence_encoder"](check)
    if fa.FLASH_BIAS_FWD.launches != before:
        raise AssertionError("the plain bias attention run launched the kernel")
    w, g = seq_plain["next_token_emb"], seq["next_token_emb"]
    max_err, mean_err = (g - w).abs().max().item(), (g - w).abs().mean().item()
    max_tol, mean_tol = 2**-6 * w.abs().max().item(), 2**-8 * w.abs().mean().item()
    ok = max_err <= max_tol and mean_err <= mean_tol
    print(f"[3] production sequence_encoder ({PROD_CHECK_BATCH} users), kernel vs plain bias attention: "
          f"next_token_emb max|err| {max_err:.3e} (tol {max_tol:.3e}), mean|err| {mean_err:.3e} "
          f"(tol {mean_tol:.3e}), held as LTHM-base -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("production kernel path and plain-attention path disagree")
    med = float(np.median(request_ms))
    return wrapper, {"request_ms": request_ms, "median_ms": med, "peak_mib": peak_mib, "counts": counts,
                     "max_err": max_err, "max_tol": max_tol}


LONG_CONTEXT, LONG_BATCH = 1024, 16  # tools/bench_longseq.py's seq and batch
LONG_REQUESTS, LONG_STEPS = 4, 3


def longseq_config() -> dict:
    """tools/bench_longseq.py's configuration in the port: LTHM-base widths
    (6 layers, d=512, MQA 32x16, FFN x4, no biases, no position bias) with
    remat at context 1024, its product tower (three cosine-LSH embeddings),
    logQ, lookahead and 8-user loss chunks; fused_ce and the table optimizer
    at their defaults (the eager CE; "auto", which resolves to a frozen
    table), as that script leaves them."""
    d = 512
    return dict(
        features={"defaults": {}},
        transformer_config=dict(
            rotator_config={"ff_mult": 4}, is_causal=True, num_layers=6,
            enable_gradient_checkpointing=True, use_flash_attention=True,
            attn_config=dict(n_head=d // 16, n_embd=d, attn_type="multi_query",
                             dropout=0.0, attn_dropout=0.0, bias=False),
        ),
        product_tower=dict(
            inp_emb_dim=32, out_emb_dim=d, product_emb_dim=128, norm_bins=20,
            cosine_lsh_config=[{"num_bins": nb, "num_proj": 32} for nb in (4, 8, 16)],
            latent_model_config={"vocab_size_latent": 1_000_000, "num_shifts_latent": 8,
                                 "normalize_embedding": True},
        ),
        log_q_config={"num_buckets": 2**22, "hash_offsets": [0, 34144]},
        lookahead=[0, 5, 12, 30],
        context_width=LONG_CONTEXT,
        softmax_temperature=0.05,
        train_mini_batch_size=8,
    )


def long_history(fa, kernels):
    """Phases [3] and [4] on the long-history path (``longseq_config``, 16
    users, T = 1025 with the CLS column): a warm-up and LONG_REQUESTS
    requests, then a warm-up step and LONG_STEPS timed steps on one batch
    with fixed lookahead offsets, every launch count set to 0 just before the
    requests and the steps and read just after (6 flash_fwd a request; 6
    flash_fwd and 6 flash_bwd a step under remat, which keeps the flash
    forward's outputs); finite unit user vectors, finite losses and
    gradients, the table as it was, the loss falling. Returns numbers for
    phase [5]."""
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState

    cfg = LTHMModelConfig.from_dict(longseq_config())
    layers = cfg.transformer_config.num_layers
    wrapper = LTHMModelWrapper(cfg, device="cuda", seed=0)
    events = LONG_CONTEXT + 8
    models = wrapper.inference_models()
    seen_t = []
    fwd = fa.fused_flash_attention_fwd

    def recording_fwd(q, *args, **kw):
        seen_t.append(q.shape[1])
        return fwd(q, *args, **kw)

    with mock.patch.object(fa, "fused_flash_attention_fwd", recording_fwd):
        models["user_encoder"](request_batch(300, LONG_BATCH, events))  # warm-up
    print(f"[3] long-history LTHM (tools/bench_longseq.py: {layers} layers, remat "
          f"{cfg.transformer_config.remat_policy}, no position bias, context {cfg.context_width}, "
          f"fused_ce {cfg.fused_ce}, table {cfg.resolved_table_optimizer()}): attention at T = {sorted(set(seen_t))}",
          flush=True)
    if set(seen_t) != {LONG_CONTEXT + 1}:
        raise AssertionError("the long-history path did not attend over T = context + 1")
    requests = [request_batch(seed, LONG_BATCH, events) for seed in range(301, 301 + LONG_REQUESTS)]
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = 0
    request_ms, outs = [], []
    for batch in requests:
        t0 = time.perf_counter()
        outs.append(models["user_encoder"](batch)["user_emb"])
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
    serve_counts = {kern.name: kern.launches for kern in kernels}
    want = {kern.name: (layers * LONG_REQUESTS if kern is fa.FLASH_FWD else 0) for kern in kernels}
    print(f"[3] {LONG_REQUESTS} long-history requests of {LONG_BATCH} users ({events} events): launches "
          f"{serve_counts} (expected {want})", flush=True)
    if serve_counts != want:
        raise AssertionError("the long-history requests did not launch flash_fwd once a layer")
    for emb in outs:
        if tuple(emb.shape) != (LONG_BATCH, cfg.product_tower.product_emb_dim) or not bool(torch.isfinite(emb).all()):
            raise AssertionError(f"long-history user_emb: shape {tuple(emb.shape)} or not finite")
        if (emb.norm(dim=-1) - 1).abs().max().item() > 1e-4:
            raise AssertionError("long-history user_emb is not unit-norm")
    del models, outs

    state = TrainState.create(wrapper, seed=1)
    table = wrapper.module.product_emb_module.embedding
    table_before = table.detach().clone()
    batch = request_batch(3000, LONG_BATCH, events)
    offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
    first_loss = train_step(state, batch, offsets=offsets)[0].item()  # warm-up, step 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    step_ms, losses, grad_norms, nans = [], [], [], []
    for _ in range(LONG_STEPS):
        t0 = time.perf_counter()
        loss, metrics = train_step(state, batch, offsets=offsets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        grad_norms.append(metrics["grad_norm"].item())
        nans.append(metrics["params_nan"].item())
    counts = {kern.name: kern.launches for kern in kernels}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    want = {kern.name: (layers if kern in (fa.FLASH_FWD, fa.FLASH_BWD) else 0) for kern in kernels}
    print(f"[4] {LONG_STEPS} long-history training steps of {LONG_BATCH} users: launches {counts} "
          f"(expected per step {want}); loss: step 1 {first_loss:.5f}, then {[round(x, 5) for x in losses]}; "
          f"grad_norm {[round(x, 4) for x in grad_norms]}; params_nan {nans}", flush=True)
    if counts != {k: n * LONG_STEPS for k, n in want.items()}:
        raise AssertionError("the long-history step did not launch each kernel of its path as expected")
    if not all(np.isfinite(losses + grad_norms + [first_loss])) or any(nans):
        raise AssertionError("a long-history step gave a non-finite loss or gradient, or NaN parameters")
    if not torch.equal(table, table_before):
        raise AssertionError("the frozen product-embedding table changed")
    if not losses[-1] < first_loss:
        raise AssertionError(f"the long-history loss did not fall over {LONG_STEPS + 1} steps on one batch")
    return {"request_ms": request_ms, "step_ms": step_ms, "peak_mib": peak_mib,
            "launches_per_request": serve_counts["flash_fwd"] // LONG_REQUESTS,
            "launches_per_step": {k: counts[k] // LONG_STEPS for k in ("flash_fwd", "flash_bwd")}}


PLAIN_BATCH = 16  # the plain bias versions store (B, H, T, T) f32 planes: timed at 16 users
# flash_bias_dkv at B=64, T=1025 in its 32-key paired design (mqa_mma_dkv_kernel),
# before the persistent 64-key kernel: this script's time for it, kept in
# PERF.md's kernel table (NVIDIA H100 80GB HBM3, 700 W); printed beside this
# run's time
PARENT_BIAS_DKV_MS = 4.8031


def time_production(fa, serving, training):
    """Phase [5] on the production path: each bias kernel alone at the
    training shape (B=64, T=1025, MQA 32x16, bf16, causal, nk=1025) with its
    inputs ready, its plain version at PLAIN_BATCH users, its bound, and
    scaled_dot_product_attention with the expanded (1, H, T, T) bias and the
    causal mask as a float attn_mask (enable_gqa), forward and, with the mask
    requiring a gradient, backward; one attention layer forward + backward on
    _sdpa with the bias against the fused bias path at T=513 and T=1025 (the
    card's answer to BIAS_MIN_SEQ); the request and the step."""
    from recommendations_tpu_torch.nn.attention import MultiQueryAttention

    b, t, h, hd, dt = BATCH, PROD_CONTEXT + 1, 32, 16, torch.bfloat16
    nk = t
    q, k, v = randn_qkv(b, t, h, hd, 1, dt, seed=13)
    g = torch.Generator(device="cuda").manual_seed(14)
    table = torch.randn(2 * nk + 1, h, generator=g, device="cuda")
    do = torch.randn(q.shape, generator=g, device="cuda").to(dt)
    n_table = table.shape[0]
    o, lse = fa.fused_flash_attention_bias_fwd(q, k, v, table, h, nk, True)
    dcol = fa._rowsum_do_o(do, o, h).contiguous()
    o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = torch.zeros((fa._BIAS_DKV_SLICES.build()(b, t, h, 1, hd, 1), n_table, h), device="cuda")
    common = (b, t, h, 1, hd, n_table, nk, 1, 1, torch.cuda.current_stream().cuda_stream)
    ptr = lambda *xs: [x.data_ptr() for x in xs]  # noqa: E731
    launch = {
        "flash_bias_fwd": lambda: fa.FLASH_BIAS_FWD.launch(*ptr(q, k, v, table, o2, lse2), *common),
        "flash_bias_dq": lambda: fa.FLASH_BIAS_DQ.launch(*ptr(q, k, v, do, lse, dcol, table, dq), *common),
        "flash_bias_dkv": lambda: fa.FLASH_BIAS_DKV.launch(
            *ptr(q, k, v, do, lse, dcol, table, dk, dv, part), *common),
    }
    times = {}
    # a note beside the bound, printed only: one exponential per live (row, head, key)
    exp_floor = b * h * t * (t + 1) // 2 / EXP_PER_S * 1e3
    for name, fn in launch.items():
        bound, by, nbytes, flops = flash_bias_bound(name, b, t, h, hd, 1, dt, True, n_table)
        times[name] = {"ms": cuda_ms(fn, 10), "bound_ms": bound, "bound_by": by}
        parent = (f"; the 32-key paired design before it took {PARENT_BIAS_DKV_MS} ms (PERF.md)"
                  if name == "flash_bias_dkv" else "")
        print(f"[5] {name} at B={b} T={t} MQA {h}x{hd} bf16 causal nk={nk}: kernel {times[name]['ms']:.4f} ms, "
              f"bound {bound:.4f} ms ({by}: {nbytes} bytes, {flops} flop); exponential floor {exp_floor:.4f} ms "
              f"(a note: one ex2 per live (row, head, key)){parent}", flush=True)

    # the plain versions at PLAIN_BATCH users (the backward's one function
    # computes dq, dk, dv and the table gradient)
    pb = PLAIN_BATCH
    pq, pk, pv, pdo = q[:pb].contiguous(), k[:pb].contiguous(), v[:pb].contiguous(), do[:pb].contiguous()
    po, plse = o[:pb].contiguous(), lse[:pb].contiguous()
    plain_fwd = cuda_ms(lambda: fa.fused_flash_attention_bias_reference(pq, pk, pv, table, h, nk, True), 2, warmup=1)
    plain_bwd = cuda_ms(lambda: fa.fused_flash_attention_bias_bwd_reference(
        pq, pk, pv, table, po, plse, pdo, h, nk, True), 2, warmup=1)
    torch.cuda.empty_cache()
    times["flash_bias_fwd"]["plain_ms"] = plain_fwd
    times["flash_bias_dq"]["plain_ms"] = times["flash_bias_dkv"]["plain_ms"] = plain_bwd
    print(f"[5] plain bias versions at B={pb} T={t}: forward {plain_fwd:.4f} ms, backward (dq, dk, dv and the "
          f"table gradient in one) {plain_bwd:.4f} ms", flush=True)

    # the library: scaled_dot_product_attention with the bias and the causal
    # mask as one float mask (the bias at bf16, as the kernels apply it)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    keep = torch.ones(t, t, dtype=torch.bool, device="cuda").tril()
    mask = torch.where(keep, fa._bias_plane(table, t, nk), float("-inf")).to(dt)[None]
    qh = q.view(b, t, h, hd).transpose(1, 2)
    kh, vh = k.view(b, t, 1, hd).transpose(1, 2), v.view(b, t, 1, hd).transpose(1, 2)
    doh = do.view(b, t, h, hd).transpose(1, 2)

    def lib_fwd():
        with torch.no_grad():
            sdpa(qh, kh, vh, attn_mask=mask, enable_gqa=True)

    qg, kg, vg, mg = (x.detach().requires_grad_() for x in (qh, kh, vh, mask))

    def lib_fwd_bwd():
        out = sdpa(qg, kg, vg, attn_mask=mg, enable_gqa=True)
        torch.autograd.grad(out, (qg, kg, vg, mg), doh)

    lib_f = cuda_ms(lib_fwd, 10)
    lib_b = cuda_ms(lib_fwd_bwd, 5) - cuda_ms(lib_fwd, 5)
    times["flash_bias_fwd"]["library_ms"] = lib_f
    times["flash_bias_dq"]["library_ms"] = times["flash_bias_dkv"]["library_ms"] = lib_b
    print(f"[5] scaled_dot_product_attention with the bias as a float attn_mask at B={b} T={t}: forward "
          f"{lib_f:.4f} ms, backward (dq, dk, dv and the mask gradient in one) {lib_b:.4f} ms", flush=True)
    del q, k, v, do, o, lse, dcol, o2, lse2, dq, dk, dv, part, pq, pk, pv, pdo, po, plse
    del mask, qh, kh, vh, doh, qg, kg, vg, mg
    torch.cuda.empty_cache()

    # one attention layer, forward + backward, _sdpa with the bias against the
    # fused bias path (taken at T == window on the card)
    crossover = {}
    for tl in (513, 1025):
        x = torch.randn(PLAIN_BATCH, tl, 512, device="cuda").to(dt).requires_grad_()
        dy = torch.randn(PLAIN_BATCH, tl, 512, device="cuda").to(dt)
        for fused in (True, False):
            layer = MultiQueryAttention(512, 32, torch.Generator(device="cuda").manual_seed(3), use_bias=False,
                                        pos_bias_window=tl, use_flash=fused, dtype=dt)

            def fwd_bwd():
                layer(x, causal=True).backward(dy)

            before = fa.FLASH_BIAS_FWD.launches
            fwd_bwd()
            if (fa.FLASH_BIAS_FWD.launches > before) != fused:
                raise AssertionError("the layer did not take the path it was timed for")
            crossover[(tl, fused)] = cuda_ms(fwd_bwd, 5)
            del layer
        torch.cuda.empty_cache()
        print(f"[5] one attention layer (B={PLAIN_BATCH}, T={tl}, d=512, MQA 32x16, bf16, position bias) "
              f"forward + backward: fused bias kernels {crossover[(tl, True)]:.4f} ms, _sdpa with the bias "
              f"{crossover[(tl, False)]:.4f} ms", flush=True)

    med = serving["median_ms"]
    print(f"[5] production user_encoder request ({BATCH} users, T={t}): median {med:.3f} ms, min "
          f"{min(serving['request_ms']):.3f} ms, max {max(serving['request_ms']):.3f} ms; "
          f"{BATCH / (med / 1e3):.1f} users/s; peak device memory {serving['peak_mib']:.1f} MiB", flush=True)
    sm = training["step_ms"]
    step_med = float(np.median(sm))
    print(f"[5] production training step ({BATCH} users, fused_ce on, remat): median {step_med:.3f} ms, min "
          f"{min(sm):.3f} ms, max {max(sm):.3f} ms over {len(sm)} steps; {BATCH / (step_med / 1e3):.1f} "
          f"examples/s; peak device memory {training['peak_mib']:.1f} MiB", flush=True)
    return times, {f"t{tl}_{'fused' if f else 'sdpa'}_ms": ms for (tl, f), ms in crossover.items()}


def timed_train(label, state, batch, offsets, steps, kernels, want):
    """A warm-up step, then ``steps`` timed steps on one batch with fixed
    lookahead offsets, every launch count set to 0 just before the timed
    steps and read just after; fails unless each kernel launched ``want``
    times a step, the losses and gradient norms are finite, no parameter
    (and no written table row) turned NaN, and the loss fell. Returns the
    numbers for phase [5]."""
    from recommendations_tpu_torch.train.step import train_step

    first = train_step(state, batch, offsets=offsets)[0].item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    step_ms, losses, grad_norms, nans = [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, metrics = train_step(state, batch, offsets=offsets)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        grad_norms.append(metrics["grad_norm"].item())
        nans.append(metrics["params_nan"].item())
    counts = {kern.name: kern.launches for kern in kernels}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    full_want = {kern.name: 0 for kern in kernels}
    full_want.update(want)
    print(f"[4] {label}: {steps} steps, launches {counts} (expected per step {full_want}); loss: step 1 "
          f"{first:.5f}, then {[round(x, 5) for x in losses]}; grad_norm {[round(x, 4) for x in grad_norms]}; "
          f"params_nan {nans}", flush=True)
    if counts != {k: n * steps for k, n in full_want.items()}:
        raise AssertionError(f"{label}: the step did not launch each kernel of its path as expected")
    if not all(np.isfinite(losses + grad_norms + [first])) or any(nans):
        raise AssertionError(f"{label}: a non-finite loss or gradient, or NaN parameters or table rows")
    if not losses[-1] < first:
        raise AssertionError(f"{label}: the loss did not fall over {steps + 1} steps on one batch")
    return {"step_ms": step_ms, "median_ms": float(np.median(step_ms)), "peak_mib": peak_mib,
            "counts": counts, "per_step": {k: n // steps for k, n in counts.items()}}


def table_rows_checked(label, wrapper, batch, before, d):
    """The table's rows after training against ``before`` (its (V, d) table
    lanes): every row that moved is one the batch's ids reach, no other row
    moved, and the rows of the real (non-padding) tokens the model reads
    moved, every one of them: the query tower keeps each history's
    ``context_width`` most recent events (the first ones), so older events
    take no gradient and are not counted."""
    from recommendations_tpu_torch.nn.embeddings import kshift_row_indices

    lm = wrapper.config.product_tower.latent_model_config
    ids = torch.as_tensor(batch["product_ids"], device="cuda")
    idx = kshift_row_indices(ids, lm.vocab_size_latent, lm.num_shifts_latent)
    reached = torch.zeros(lm.vocab_size_latent, dtype=torch.bool, device="cuda")
    reached[idx.reshape(-1)] = True
    cw = wrapper.config.context_width
    real = torch.zeros_like(reached)
    real[idx[:, :cw][ids[:, :cw] != 0].reshape(-1)] = True
    moved = (wrapper.module.product_emb_module.embedding.detach()[:, :d] != before).any(dim=1)
    stray, n_moved, n_real = int((moved & ~reached).sum()), int(moved.sum()), int(real.sum())
    missed = int((real & ~moved).sum())
    ok = stray == 0 and missed == 0
    print(f"[4] {label}: {n_moved} table rows moved of {lm.vocab_size_latent}; the batch's real tokens reach "
          f"{n_real} rows, {missed} of them unmoved; {stray} rows moved that no id reaches "
          f"-> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: the table's rows moved where the batch did not reach them, or did not move")
    return {"rows_moved": n_moved, "rows_reached_by_real_tokens": n_real}


def table_update_ms(wrapper, state, batch):
    """The table's own update alone, on CUDA events, at the path's shape:
    the fused record's (random tap gradients of the batch's shape), the lazy
    rows' (the table's last gradient), or RowwiseAdam's step (the same)."""
    cfg = wrapper.config
    table = wrapper.module.product_emb_module.embedding
    if wrapper.uses_sparse_taps():
        ids = torch.as_tensor(batch["product_ids"])
        k, d = cfg.product_tower.latent_model_config.num_shifts_latent, cfg.product_tower.inp_emb_dim
        g = torch.randn((*ids.shape, k, d), device="cuda").to(getattr(torch, cfg.compute_dtype)) * 1e-3
        holder = {"state": state.table_state}

        def run():
            holder["state"], _ = wrapper.apply_sparse_table_update({"product_emb_rows": g}, holder["state"], batch)
    elif wrapper.uses_lazy_table():
        grad, holder = table.grad.clone(), {"state": state.table_state}

        def run():
            holder["state"] = wrapper.apply_lazy_table_update(grad, holder["state"], batch)
    else:
        run = state.optimizer.table.step
    return cuda_ms(run, 5, warmup=1)


def trainable_base(fa, fc, kernels):
    """Phase [4] on LTHM-base with a trainable table (detach_item_tower
    false; 1M rows): rowwise_adam (what ``auto`` resolves to there),
    lazy_rowwise_adam, and sparse_fused_adam forced: a warm-up and
    TABLE_STEPS timed steps each, launch counts (6 flash_fwd, 6 flash_bwd and
    12 of each CE kernel a step), the table rows that moved, and the table
    update alone. Returns numbers for phase [5]."""
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.train.train_state import TrainState

    out = {}
    for opt in ("rowwise_adam", "lazy_rowwise_adam", "sparse_fused_adam"):
        d = bench_config()
        d["table_optimizer"] = opt
        d["product_tower"]["detach_item_tower"] = False
        cfg = LTHMModelConfig.from_dict(d)
        wrapper = LTHMModelWrapper(cfg, device="cuda", seed=0)
        state = TrainState.create(wrapper, seed=1)
        dim = cfg.product_tower.inp_emb_dim
        before = wrapper.module.product_emb_module.embedding.detach()[:, :dim].clone()
        batch = request_batch(1000)
        offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
        layers, heads, chunks = cfg.transformer_config.num_layers, len(cfg.lookahead), BATCH // cfg.train_mini_batch_size
        want = {"flash_fwd": layers, "flash_bwd": layers, **{k.name: heads * chunks for k in fc.KERNELS}}
        label = f"LTHM-base, table_optimizer {opt} (auto resolves to {dataclasses.replace(cfg, table_optimizer='auto').resolved_table_optimizer()})"
        res = timed_train(label, state, batch, offsets, TABLE_STEPS, kernels, want)
        res.update(table_rows_checked(label, wrapper, batch, before, dim))
        res["update_ms"] = table_update_ms(wrapper, state, batch)
        print(f"[4] {label}: the table update alone {res['update_ms']:.4f} ms (CUDA events)", flush=True)
        out[opt] = res
        del wrapper, state, before
        torch.cuda.empty_cache()
    return out


def trainable_production(fa, fc, kernels):
    """Phase [4] on the production LTHM at context 1024 with a trainable
    10M-row table (detach_item_tower false): ``auto`` resolves to
    sparse_fused_adam (the fused (V, 128) record, 5.12 GB), then
    rowwise_adam forced; a warm-up and TABLE_STEPS timed steps each (16 of
    each bias kernel and 12 of each CE kernel a step), the rows moved, and
    the table update alone. Returns numbers for phase [5]."""
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.train.train_state import TrainState

    out = {}
    for opt in ("auto", "rowwise_adam"):
        d = production_config()
        d["table_optimizer"] = opt
        d["product_tower"]["detach_item_tower"] = False
        cfg = LTHMModelConfig.from_dict(d)
        resolved = cfg.resolved_table_optimizer()
        if opt == "auto" and resolved != "sparse_fused_adam":
            raise AssertionError(f"auto resolved to {resolved} at 10M rows")
        t0 = time.perf_counter()
        wrapper = LTHMModelWrapper(cfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        table = wrapper.module.product_emb_module.embedding
        state = TrainState.create(wrapper, seed=1)
        dim = cfg.product_tower.inp_emb_dim
        before = table.detach()[:, :dim].clone()
        events = PROD_CONTEXT + 8
        batch = request_batch(2000, BATCH, events)
        offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
        layers, heads, chunks = cfg.transformer_config.num_layers, len(cfg.lookahead), BATCH // cfg.train_mini_batch_size
        want = {"flash_bias_fwd": layers, "flash_bias_dq": layers, "flash_bias_dkv": layers,
                **{k.name: heads * chunks for k in fc.KERNELS}}
        label = (f"production, context 1024, table_optimizer {opt} -> {resolved}, "
                 f"table {tuple(table.shape)} built in {built_s:.2f} s")
        res = timed_train(label, state, batch, offsets, TABLE_STEPS, kernels, want)
        res.update(table_rows_checked(label, wrapper, batch, before, dim))
        res["update_ms"] = table_update_ms(wrapper, state, batch)
        print(f"[4] {label}: the table update alone {res['update_ms']:.4f} ms (CUDA events)", flush=True)
        out[resolved] = res
        del wrapper, state, before, table
        torch.cuda.empty_cache()
    return out


def production_512(fa, fc, kernels):
    """Phases [3] and [4] on the production LTHM at lthm.yaml's own context
    512 (T = 513 = the bias window, CE N = 16384; frozen table; random
    bf16 position-bias tables in place of the initial zeros): a warm-up
    and PROD_REQUESTS requests and a warm-up and PROD_STEPS timed steps
    under the CUDA dispatch (the fused bias kernels at T == window, 16 each a
    step), then a warm-up and one timed step under the JAX package's
    dispatch (_sdpa with the bias, no bias kernel), each with its peak
    memory; one step's loss and gradients of the two dispatches on the same
    state and batch held to each other. Returns numbers for phase [5]."""
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.train.train_state import TrainState

    cfg = LTHMModelConfig.from_dict(production_config(CTX512))
    t = CTX512 + 1
    if cfg.transformer_config.attn_config.pos_bias.context_window != t or not fa.fused_flash_bias_taken(t, t, True):
        raise AssertionError("the context-512 path does not take the bias kernels under the CUDA dispatch")
    layers, heads, chunks = cfg.transformer_config.num_layers, len(cfg.lookahead), BATCH // cfg.train_mini_batch_size
    wrapper = LTHMModelWrapper(cfg, device="cuda", seed=0)
    # the position-bias tables start at zeros: random bf16 values, so that a
    # bias kernel that ignored the table or read the wrong rows would fail the
    # comparison with _sdpa below
    n_tables = random_bias_tables(wrapper, 7)
    if n_tables != layers:
        raise AssertionError(f"{n_tables} position-bias tables in {layers} layers")
    models = wrapper.inference_models()
    events = CTX512 + 8
    models["user_encoder"](request_batch(500, BATCH, events))  # warm-up
    requests = [request_batch(seed, BATCH, events) for seed in range(501, 501 + PROD_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    request_ms = []
    for batch in requests:
        t0 = time.perf_counter()
        emb = models["user_encoder"](batch)["user_emb"]
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        if tuple(emb.shape) != (BATCH, cfg.product_tower.product_emb_dim) or not bool(torch.isfinite(emb).all()):
            raise AssertionError("production context-512 user_emb: wrong shape or not finite")
        if (emb.norm(dim=-1) - 1).abs().max().item() > 1e-4:
            raise AssertionError("production context-512 user_emb is not unit-norm")
    serve_counts = {kern.name: kern.launches for kern in kernels}
    serve_peak = torch.cuda.max_memory_allocated() / 2**20
    want = {kern.name: (layers * PROD_REQUESTS if kern is fa.FLASH_BIAS_FWD else 0) for kern in kernels}
    print(f"[3] {PROD_REQUESTS} production requests at context {CTX512} (T = {t} = the window, CUDA dispatch) of "
          f"{BATCH} users: launches {serve_counts} (expected {want})", flush=True)
    if serve_counts != want:
        raise AssertionError("the context-512 requests did not launch the bias forward once a layer")
    del models

    state = TrainState.create(wrapper, seed=1)
    batch = request_batch(2500, BATCH, events)
    offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
    fused = timed_train(f"production, context {CTX512}, CUDA dispatch (fused bias kernels at T = {t})", state,
                        batch, offsets, PROD_STEPS, kernels,
                        {"flash_bias_fwd": layers, "flash_bias_dq": layers, "flash_bias_dkv": layers,
                         **{k.name: heads * chunks for k in fc.KERNELS}})
    loss_k, grads_k = grads_of(wrapper, batch, state.aux, offsets)
    taken = fa.fused_flash_bias_taken
    # the JAX package's dispatch, the CPU's: _sdpa at T = 513 < BIAS_MIN_SEQ
    with mock.patch.object(fa, "fused_flash_bias_taken", lambda t, w, on_cuda: taken(t, w, False)):
        before = {kern.name: kern.launches for kern in kernels[:5]}
        other = grads_of(wrapper, batch, state.aux, offsets)
        if {kern.name: kern.launches for kern in kernels[:5]} != before:
            raise AssertionError("the _sdpa dispatch launched a flash kernel")
        sdpa = timed_train(f"production, context {CTX512}, the JAX package's dispatch (_sdpa with the bias)",
                           state, batch, offsets, 1, kernels, {k.name: heads * chunks for k in fc.KERNELS})
    held_to(f"production context {CTX512}, CUDA dispatch vs the JAX package's (_sdpa)", other, grads_k, loss_k,
            2**-4, 1e-2,
            f"_sdpa rounds each logit to bf16 before its softmax and p to bf16 before PV, the kernels keep "
            f"f32 logits: held as the CPU tests hold bf16 against JAX (2**-4, the loss 1e-2) over {layers} layers")
    del grads_k, other
    request_med = float(np.median(request_ms))
    del wrapper, state
    torch.cuda.empty_cache()
    return {"request_ms": request_ms, "request_median_ms": request_med, "serve_peak_mib": serve_peak,
            "serve_counts": serve_counts, "fused": fused, "sdpa": sdpa}


TRAINER_STEPS, TRAINER_VAL_BATCHES = 8, 2
TRAINER_USERS_PER_FILE, TRAINER_HISTORY = 320, 768  # lthm.yaml pads history to 768; 2 files: 10 batches of 64


def expected_metric_keys(model_cfg, prefix: str) -> set:
    """The metric keys the JAX package's loss logs under ``prefix`` (train
    or val) for an LTHM config, and the trainer's own."""
    per_head = ["average_hit_position", "average_negatives_per_token", "effective_batch_size",
                "loss_all_tokens", "median_hit_position", "offset", "used_tokens"]
    per_head += [f"hit_rate_at_{k}" for k in model_cfg.metrics_k_all]
    keys = {f"{prefix}_{name}_lookahead_{i}" for name in per_head for i in range(len(model_cfg.lookahead))}
    keys |= {f"{prefix}_loss", f"{prefix}_batch_size", f"{prefix}_seq_len"}
    if prefix == "train":
        keys |= {"grad_norm", "params_nan", "training speed - samples per second", "epoch", "steps"}
    else:
        keys |= {"val_batches_skipped_nan", "eval speed - samples per second", "RAM Available - GB"}
    return keys


def trainer_path(fa, kernels, smi):
    """Phase [4]: the port's entry point, ``main_training``, on
    configs/lthm_train.yaml (the production LTHM at context 512, T = 513 =
    the bias window, eager CE, frozen 10M-row table) at batch 64, on data
    from the port's synth_data in the in-memory store (``kind=fake``;
    histories of 768 events), for TRAINER_STEPS steps with
    TRAINER_VAL_BATCHES validation batches every 4 steps, a checkpoint and
    an export every 4 steps, metrics every 4 steps to a jsonl tracker. The
    launch counts are set to 0 just before the run and read just after: 16
    of each bias kernel a trained step, and 16 bias forwards a validation
    batch; the eager CE's rounded kernels, one of each a lookahead head and
    loss chunk a step, and one ce_row_diag_rounded and ce_fwd_rounded a head
    a validation batch (one chunk). Then the step-4 checkpoint (written by the checkpoint manager's
    background thread) resumes in a second run, whose steps 5-8 must give
    the same bits as the first run's, and whose checkpoint is on disk
    before its turn ends (``wait()`` right after ``save``): the checkpoint
    turns of both runs and the save's host copy are printed. The export
    loads into a fresh wrapper that serves the same user vectors. Returns
    the numbers for phase [5]."""
    import tempfile

    from recommendations_tpu_torch import main_training
    from recommendations_tpu_torch.data.data_store import FakeDataStore
    from recommendations_tpu_torch.ops import fused_ce as fc
    from recommendations_tpu_torch.pipeline.export import load_exported_wrapper
    from recommendations_tpu_torch.tools.synth_data import write_synthetic_dataset
    from recommendations_tpu_torch.train import checkpoint as ckpt_mod

    t0 = time.perf_counter()
    FakeDataStore.reset()
    write_synthetic_dataset(None, ["20240101"], files_per_date=2, users_per_file=TRAINER_USERS_PER_FILE,
                            history_len=TRAINER_HISTORY, fake_store=True)
    synth_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    bias = (fa.FLASH_BIAS_FWD, fa.FLASH_BIAS_DQ, fa.FLASH_BIAS_DKV)
    save_ms = {"a": [], "b": []}  # each CheckpointManager.save call's host time, by run
    real_save = ckpt_mod.CheckpointManager.save
    counted = (*kernels, *fc.ROUNDED_KERNELS)  # the YAML leaves fused_ce unset: the rounded case
    try:
        def run(tag, ckpt_dir, sync=False):
            """One main_training run; with ``sync`` each checkpoint is on
            disk before its turn ends (``wait()`` right after ``save``)."""
            def timed_save(mgr, *a, **kw):
                t = time.perf_counter()
                real_save(mgr, *a, **kw)
                save_ms[tag].append((time.perf_counter() - t) * 1e3)
                if sync:
                    mgr.wait()

            ckpt_mod.CheckpointManager.save = timed_save
            argv = ["--config-name", "lthm_train", "datestr=20240101", "dataset.filesystem_config.kind=fake",
                    f"train.train_steps={TRAINER_STEPS}", f"train.validation_steps={TRAINER_VAL_BATCHES}",
                    "train.val_metrics_every_n_steps=4", "train.checkpoint_every_k_steps=4",
                    "train.train_metrics_every_n_steps=4", f"checkpoint_dir={ckpt_dir}",
                    f"export.filesystem_config.local_dir_prefix={tmp}/export_{tag}",
                    f"trackers.trackers=[{{kind: jsonl, path: {tmp}/{tag}.jsonl}}]",
                    f"model_version={tag}", f"run_id=chip_smoke_{tag}"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kern in counted:
                kern.launches = 0
            t1 = time.perf_counter()
            try:
                pipeline, metrics = main_training.main(argv, return_pipeline=True)
            finally:
                ckpt_mod.CheckpointManager.save = real_save
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
            counts = {kern.name: kern.launches for kern in counted}
            return pipeline, metrics, counts, torch.cuda.max_memory_allocated() / 2**20, seconds

        pipe_a, met_a, counts_a, peak_a, secs_a = run("a", f"{tmp}/ckpt_a")
        wrapper, state_a = pipe_a._trained
        cfg = wrapper.config
        layers = cfg.transformer_config.num_layers
        val_runs = TRAINER_STEPS // 4
        heads, batch_size, mini = len(cfg.lookahead), cfg_batch(pipe_a), cfg.train_mini_batch_size
        chunks = -(-batch_size // mini) if 0 < mini < batch_size else 1
        rounded_step = {kern.name: heads * chunks for kern in fc.ROUNDED_KERNELS}
        rounded_val = {kern.name: heads if kern in (fc.CE_ROW_DIAG_ROUNDED, fc.CE_FWD_ROUNDED) else 0
                       for kern in fc.ROUNDED_KERNELS}

        def expected(steps, val_batches):
            want = {kern.name: 0 for kern in counted}
            want.update({"flash_bias_fwd": layers * (steps + val_batches), "flash_bias_dq": layers * steps,
                         "flash_bias_dkv": layers * steps})
            want.update({name: n * steps + rounded_val[name] * val_batches for name, n in rounded_step.items()})
            return want

        want = expected(TRAINER_STEPS, val_runs * TRAINER_VAL_BATCHES)
        print(f"[4] main_training on lthm_train.yaml ({TRAINER_STEPS} steps of {batch_size} users, "
              f"{TRAINER_VAL_BATCHES} validation batches every 4 steps, synth data {synth_s:.1f} s): launches "
              f"{counts_a} (expected {want}: {layers} of each bias kernel a step, {layers} bias forwards a "
              f"validation batch, {heads * chunks} of each rounded CE kernel a step, {heads} of the rounded "
              f"forward pair a validation batch)", flush=True)
        if counts_a != want:
            raise AssertionError("the trainer's steps did not launch each bias and rounded CE kernel as expected")
        if state_a.step != TRAINER_STEPS:
            raise AssertionError(f"the trainer stopped at step {state_a.step}, not {TRAINER_STEPS}")

        # the jsonl tracker: train and validation lines under the JAX package's keys
        with open(f"{tmp}/a.jsonl") as f:
            records = [json.loads(line) for line in f]
        lines = [r for r in records if r["event"] == "metrics"]
        train_lines = [r for r in lines if "train_loss" in r["metrics"]]
        val_lines = [r for r in lines if "val_loss" in r["metrics"]]
        if [r["metrics"]["steps"] for r in train_lines] != [4, 8] or len(val_lines) != 2:
            raise AssertionError(f"jsonl: train lines at steps {[r['metrics'].get('steps') for r in train_lines]}, "
                                 f"{len(val_lines)} validation lines")
        for r in train_lines + val_lines:
            prefix = "train" if r in train_lines else "val"
            if set(r["metrics"]) != expected_metric_keys(cfg, prefix):
                raise AssertionError(f"jsonl {prefix} keys differ: {sorted(set(r['metrics']) ^ expected_metric_keys(cfg, prefix))}")
        losses = [r["metrics"][f"{p}_loss"] for r, p in [(r, "train") for r in train_lines] + [(r, "val") for r in val_lines]]
        if not np.isfinite(losses).all():
            raise AssertionError(f"a logged loss is not finite: {losses}")
        batch_size = cfg_batch(pipe_a)
        if [r["step"] for r in lines] != [4 * batch_size] * 2 + [TRAINER_STEPS * batch_size] * 2:
            raise AssertionError(f"jsonl steps {[r['step'] for r in lines]}: not the samples seen, as JAX logs")
        print(f"[4] jsonl: {len(train_lines)} train and {len(val_lines)} validation lines under the JAX "
              f"package's keys; losses {[round(x, 5) for x in losses]} (train, then val)", flush=True)

        # resume: the step-4 checkpoint, steps 5-8 again
        os.makedirs(f"{tmp}/ckpt_b")
        shutil.copy(f"{tmp}/ckpt_a/step_00000004.pt", f"{tmp}/ckpt_b/step_00000004.pt")
        pipe_b, met_b, counts_b, _, secs_b = run("b", f"{tmp}/ckpt_b", sync=True)
        state_b = pipe_b._trained[1]
        resumed = TRAINER_STEPS - 4
        want_b = expected(resumed, TRAINER_VAL_BATCHES)
        if counts_b != want_b:
            raise AssertionError(f"the resumed run's launches {counts_b}, expected {want_b}")
        sd_a, sd_b = state_a.state_dict(), state_b.state_dict()
        differ = [name for name, t in sd_a["module"].items() if not torch.equal(t, sd_b["module"][name])]
        for i, (oa, ob) in enumerate(zip(sd_a["optimizers"], sd_b["optimizers"])):
            for pid, st in oa["state"].items():
                differ += [f"optimizer{i}.{pid}.{k}" for k, t in st.items()
                           if torch.is_tensor(t) and not torch.equal(t, ob["state"][pid][k])]
        differ += [f"aux.logq.{k}" for k in ("a", "b") if not torch.equal(getattr(state_a.aux.logq, k),
                                                                          getattr(state_b.aux.logq, k))]
        if not torch.equal(state_a.aux.batch_idx, state_b.aux.batch_idx) or state_b.step != TRAINER_STEPS:
            differ.append("aux.batch_idx or step")
        print(f"[4] resumed from the step-4 checkpoint, steps 5-{TRAINER_STEPS} again: launches {counts_b}; "
              f"{len(sd_a['module'])} parameters and buffers, the AdamW moments and the logQ state "
              f"{'bit-equal to the uninterrupted run' if not differ else 'DIFFER: ' + ', '.join(differ[:8])}",
              flush=True)
        if differ:
            raise AssertionError("the resumed run's state differs from the uninterrupted run's")
        del pipe_b, state_b, sd_b

        # the checkpoint turns: run a's (steps 4 and 8) write in the background,
        # run b's (step 8) waits for its write; both also validate, log and export
        async_turns = [met_a["step_times_s"][i - 1] * 1e3 for i in (4, 8)]
        sync_turns = [met_b["step_times_s"][TRAINER_STEPS - 4 - 1] * 1e3]
        gb = sum(t.numel() * t.element_size() for t in state_a.state_dict()["module"].values()) / 1e9
        print(f"[4] {smi}: checkpoint turns (lthm_train.yaml: the module's state {gb:.2f} GB, the AdamW "
              f"moments beside it): written in the background, turns 4 and 8 {[round(x, 3) for x in async_turns]} ms "
              f"(median {float(np.median(async_turns)):.3f}); save() on the loop's thread (the host copy) "
              f"{[round(x, 3) for x in save_ms['a']]} ms; written before the turn ends (wait() right after save, "
              f"the resumed run), turn 8 {[round(x, 3) for x in sync_turns]} ms (median "
              f"{float(np.median(sync_turns)):.3f}), its save() and wait() {[round(x, 3) for x in save_ms['b']]} "
              f"ms; the resume above read run a's background-written step-4 checkpoint", flush=True)
        if len(save_ms["a"]) != 2 or len(save_ms["b"]) != 1:
            raise AssertionError(f"checkpoint saves {save_ms}: expected 2 in run a and 1 in run b")

        # the export serves the same user vectors in a fresh wrapper
        export_dir = pipe_a.export_dir()
        fresh = load_exported_wrapper(export_dir, device="cuda")
        batch = request_batch(4242, 64, CTX512 + 8)
        want_emb = wrapper.inference_models()["user_encoder"](batch)["user_emb"]
        got_emb = fresh.inference_models()["user_encoder"](batch)["user_emb"]
        same = torch.equal(want_emb, got_emb)
        print(f"[4] export ({export_dir}: params/ and config.json) loaded into a fresh LTHMModelWrapper: "
              f"user_encoder on 64 users {'bit-equal to the trained model' if same else 'DIFFERS'}", flush=True)
        if not same:
            raise AssertionError("the exported model serves other user vectors than the trained one")
        del fresh

        # train_step called directly on one batch of the trainer's shapes, on
        # the trained state: the loop's own cost is the difference
        direct = timed_train("lthm_train.yaml's model, train_step called directly (fused_ce off, as the YAML)",
                             state_a, request_batch(4343, cfg_batch(pipe_a), TRAINER_HISTORY),
                             [0, 5, 6, 12, 24, 30], PROD_STEPS, counted,
                             {"flash_bias_fwd": layers, "flash_bias_dq": layers, "flash_bias_dkv": layers,
                              **rounded_step})

        stages = met_a["feed_path_stages"]
        turns = met_a["step_times_s"]
        # the turns that neither validate, checkpoint nor log, the first (warm-up) left out
        plain = [x for i, x in enumerate(turns, start=1) if i > 1 and i % 4]
        wait = stages.get("step.next_batch_wait", {}).get("total_s", 0.0)
        return {"ckpt_turn_async_ms": async_turns, "ckpt_turn_sync_ms": sync_turns, "ckpt_save_ms": save_ms,
                "turn_ms": [x * 1e3 for x in turns], "median_ms": float(np.median(plain)) * 1e3,
                "plain_turns": len(plain), "all_median_ms": float(np.median(turns)) * 1e3, "direct": direct,
                "peak_mib": peak_a, "feed_wait_share": wait / sum(turns), "stages": stages,
                "seconds": secs_a, "resume_seconds": secs_b, "counts": counts_a,
                "per_step": {"flash_bias_fwd": layers, "flash_bias_dq": layers, "flash_bias_dkv": layers},
                "batch": cfg_batch(pipe_a)}
    finally:
        ckpt_mod.CheckpointManager.save = real_save
        shutil.rmtree(tmp, ignore_errors=True)
        FakeDataStore.reset()


KNOB_STEPS = 8  # micro-steps of the trainer phase with every knob on
KNOB_TURN_STEPS = 2  # steps_per_dispatch of its main run
# every trainer knob of slice 12 on lthm_train.yaml at full width: the
# SelfAttentionConfig default rates, accumulation, two steps a dispatch, the
# spawned reader (bypass_dataloader off: the YAML bypasses the loader, which
# the process reader needs), grouping by product_id (the last item of a
# history: users share it, so the groups have repeated keys) sorted by
# customer_id, a shuffle buffer (so a resume takes the snapshot), the fused CE
KNOB_ARGS = ("model.fused_ce=true", "model.transformer_config.attn_config.dropout=0.1",
             "model.transformer_config.attn_config.attn_dropout=0.1", "train.gradient_accumulation_steps=2",
             "data_loader.bypass_dataloader=false", "data_loader.process_reader=true",
             "data_loader.shuffle_buffer_num_mini_batches=2",
             "model.features.group_dataset={group_by_columns: [product_id], sort_by_columns: [customer_id], "
             "minimum_group_size: 1}")
KNOB_KERNEL_NAMES = {  # the device names the profiler records for each kernel of the path
    "flash_bias_fwd": "mqa_tc_bias_fwd_kernel", "flash_bias_dq": "mqa_tc_bias_dq_kernel",
    "flash_bias_dkv": "mqa_tc_bias_dkv_kernel", "ce_row_diag": "row_diag_kernel", "ce_fwd": "ce_fwd_tc_kernel",
    "ce_dq": "ce_grad_tc_kernel", "ce_dc": "ce_grad_tc_kernel",
}


def same_state_bits(sa, sb) -> list:
    """The names of the state's tensors that differ between two runs: the
    parameters, the optimizer moments and accumulation, the logQ state, the
    step and the generators."""
    da, db = sa.state_dict(), sb.state_dict()
    differ = [n for n, t in da["module"].items() if not torch.equal(t, db["module"][n])]
    for i, (oa, ob) in enumerate(zip(da["optimizers"], db["optimizers"])):
        for pid, st in oa["state"].items():
            differ += [f"optimizer{i}.{pid}.{k}" for k, t in st.items()
                       if torch.is_tensor(t) and not torch.equal(t, ob["state"][pid][k])]
    acc_a, acc_b = da["accumulation"], db["accumulation"]
    if acc_a["mini_step"] != acc_b["mini_step"] or set(acc_a["acc"]) != set(acc_b["acc"]) or not all(
            torch.equal(t, acc_b["acc"][i]) for i, t in acc_a["acc"].items()):
        differ.append("accumulation")
    differ += [f"aux.logq.{k}" for k in ("a", "b") if not torch.equal(getattr(sa.aux.logq, k), getattr(sb.aux.logq, k))]
    if not torch.equal(sa.aux.batch_idx, sb.aux.batch_idx) or sa.step != sb.step:
        differ.append("aux.batch_idx or step")
    differ += [g for g in ("generator", "dropout_generator") if not torch.equal(da[g], db[g])]
    return differ


def trainer_knobs(fa, fc, kernels, ce_per_step):
    """Phase [4]: main_training on configs/lthm_train.yaml at full width (16
    layers, context 512, MQA 32x16, bf16, the 10M-row table frozen) with
    every knob of the single-GPU trainer on (``KNOB_ARGS``): dropout 0.1
    on q/k/v tokens and on the residual branches, gradient accumulation 2,
    the process reader, grouping and a shuffle buffer, the fused CE; on the
    in-memory store filled by the port's synth_data, KNOB_STEPS micro-steps
    of 64 users. Run A: two steps a dispatch, a checkpoint every 4 steps
    (the iterator snapshot beside it) and profile capture over steps 5-6,
    its launch counts set to 0 just before it and read just after (16 of
    each bias kernel and ``ce_per_step`` of each CE kernel a step). Run B:
    one step a dispatch; its state must equal A's bit for bit. Run C: from
    A's step-4 checkpoint through the snapshot; equal to A bit for bit. The
    profile's Chrome trace must name the bias and CE kernels. Then on A's
    model: one forward and backward with dropout, whose first layer's
    dropped-out q, k, v (and table) and first CE chunk hold the kernels to
    their plain versions again, and whose masks keep 0.9 within 4 binomial
    standard deviations; remat on against off with dropout. Then
    debug_numerics on lthm_tiny (2 layers, fused CE): a clean step's loss
    unchanged, a planted NaN weight raising with the operation's name, a
    NaN in a kernel's input raising with the kernel's name. Returns the
    numbers for phase [5]."""
    import logging
    import tempfile

    from recommendations_tpu_torch import main_training
    from recommendations_tpu_torch.core import debug
    from recommendations_tpu_torch.data.data_store import FakeDataStore
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.nn import dropout as tdrop
    from recommendations_tpu_torch.tools.synth_data import write_synthetic_dataset
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState

    FakeDataStore.reset()
    write_synthetic_dataset(None, ["20240101"], files_per_date=2, users_per_file=TRAINER_USERS_PER_FILE,
                            history_len=TRAINER_HISTORY, fake_store=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_knobs_")
    messages = []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    handler = Keep(level=logging.INFO)
    strategy_log = logging.getLogger("recommendations_tpu_torch.train.strategy")
    strategy_log.addHandler(handler)
    old_level = strategy_log.level
    strategy_log.setLevel(logging.INFO)
    try:
        def run(tag, extra):
            argv = ["--config-name", "lthm_train", "datestr=20240101", "dataset.filesystem_config.kind=fake",
                    f"train.train_steps={KNOB_STEPS}", "train.validation_steps=0", "train.train_metrics_every_n_steps=4",
                    "export=null", f"trackers.trackers=[{{kind: jsonl, path: {tmp}/{tag}.jsonl}}]",
                    f"model_version={tag}", f"run_id=chip_smoke_{tag}", *KNOB_ARGS, *extra]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kern in kernels:
                kern.launches = 0
            t1 = time.perf_counter()
            pipeline, metrics = main_training.main(argv, return_pipeline=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t1
            return (pipeline._trained, metrics, {kern.name: kern.launches for kern in kernels},
                    torch.cuda.max_memory_allocated() / 2**20, seconds)

        (wrapper, state_a), met_a, counts_a, peak_a, secs_a = run("a", [
            f"train.steps_per_dispatch={KNOB_TURN_STEPS}", "train.checkpoint_every_k_steps=4",
            f"checkpoint_dir={tmp}/ckpt_a", f"training_strategy.profile_dir={tmp}/profile",
            "training_strategy.profile_start_step=4", "training_strategy.profile_num_steps=2"])
        cfg = wrapper.config
        layers = cfg.transformer_config.num_layers
        per_step = {kern.name: 0 for kern in kernels}
        per_step.update({"flash_bias_fwd": layers, "flash_bias_dq": layers, "flash_bias_dkv": layers,
                         **{name: ce_per_step[name] for name in ("ce_row_diag", "ce_fwd", "ce_dq", "ce_dc")}})
        want = {k: n * KNOB_STEPS for k, n in per_step.items()}
        print(f"[4] main_training on lthm_train.yaml with every trainer knob ({KNOB_STEPS} micro-steps of 64 "
              f"users, dropout {cfg.transformer_config.attn_config.dropout}/"
              f"{cfg.transformer_config.attn_config.attn_dropout}, accumulation 2, {KNOB_TURN_STEPS} steps a "
              f"dispatch, process reader, grouping by product_id with a shuffle buffer, fused CE, profile over "
              f"steps 5-6, a checkpoint every 4): launches {counts_a} (expected {want}); {secs_a:.1f} s", flush=True)
        if counts_a != want or state_a.step != KNOB_STEPS:
            raise AssertionError("the knobs run did not launch each kernel of its path as expected")
        if sorted(os.listdir(f"{tmp}/ckpt_a")) != ["data_iter_h0_s4.pkl", "data_iter_h0_s8.pkl",
                                                  "step_00000004.pt", "step_00000008.pt"]:
            raise AssertionError(f"checkpoints and snapshots: {sorted(os.listdir(f'{tmp}/ckpt_a'))}")
        if not np.isfinite(met_a["train_loss"]):
            raise AssertionError("the knobs run's loss is not finite")

        # the profile: a Chrome trace that names the path's kernels
        traces = os.listdir(f"{tmp}/profile")
        with open(os.path.join(tmp, "profile", traces[0])) as f:
            trace_names = {e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
        named = {k: any(dev in n for n in trace_names) for k, dev in KNOB_KERNEL_NAMES.items()}
        print(f"[4] profile: {traces} ({len(trace_names)} distinct device kernels); the path's kernels named: "
              f"{named}", flush=True)
        if len(traces) != 1 or not all(named.values()):
            raise AssertionError("the profile trace does not name every kernel of the path")

        # B: one step a dispatch gives A's bits
        (_, state_b), met_b, counts_b, peak_b, secs_b = run("b", ["train.steps_per_dispatch=1"])
        differ_b = same_state_bits(state_a, state_b)
        print(f"[4] steps_per_dispatch 1 against {KNOB_TURN_STEPS}, {KNOB_STEPS} micro-steps: launches {counts_b}; "
              f"{'bit-equal' if not differ_b else 'DIFFER: ' + ', '.join(differ_b[:8])}", flush=True)
        if differ_b or counts_b != want:
            raise AssertionError("steps_per_dispatch changed the trained state")
        turns_b = met_b["step_times_s"]
        del state_b

        # C: resumed from A's step-4 checkpoint through the iterator snapshot
        os.makedirs(f"{tmp}/ckpt_c")
        for name in ("step_00000004.pt", "data_iter_h0_s4.pkl"):
            shutil.copy(f"{tmp}/ckpt_a/{name}", f"{tmp}/ckpt_c/{name}")
        messages.clear()
        (_, state_c), _, counts_c, _, secs_c = run("c", [
            f"train.steps_per_dispatch={KNOB_TURN_STEPS}", "train.checkpoint_every_k_steps=4",
            f"checkpoint_dir={tmp}/ckpt_c"])
        restored = [m for m in messages if "data-iterator snapshot" in m]
        differ_c = same_state_bits(state_a, state_c)
        print(f"[4] resumed from the step-4 checkpoint: {restored or 'NO SNAPSHOT RESTORE'}; launches {counts_c}; "
              f"{'bit-equal to the uninterrupted run' if not differ_c else 'DIFFER: ' + ', '.join(differ_c[:8])}",
              flush=True)
        if not restored or any("(replay)" in m for m in messages) or differ_c:
            raise AssertionError("the resume did not restore the snapshot to the uninterrupted run's bits")
        del state_c
        torch.cuda.empty_cache()

        # one forward and backward of A's model with dropout: the kernels'
        # inputs of one layer and one CE chunk, and the masks' keep rate
        captured, kept = {}, []
        real_bias, real_ce, real_keep = fa.fused_flash_attention_bias_fwd, fc.ce_forward, tdrop.dropout_keep

        def bias_fwd(q, k, v, table, n_head, nk, causal=True):
            captured.setdefault("bias", (q.detach().clone(), k.detach().clone(), v.detach().clone(),
                                         table.detach().clone(), n_head, nk, causal))
            return real_bias(q, k, v, table, n_head, nk, causal)

        def ce_fwd(q16, c16, v, lq, s, inv_t, beta, round_logits=False):
            captured.setdefault("ce", (q16.detach().clone(), c16.detach().clone(), v.clone(), lq.clone(), s, beta))
            return real_ce(q16, c16, v, lq, s, inv_t, beta, round_logits)

        def keep(generator, keep_prob, shape, device):
            mask = real_keep(generator, keep_prob, shape, device)
            kept.append((mask.sum(), mask.numel(), keep_prob))
            return mask

        batch = request_batch(4646, BATCH, TRAINER_HISTORY)
        offsets = sample_offsets(torch.Generator().manual_seed(6), cfg.lookahead)
        with mock.patch.object(fa, "fused_flash_attention_bias_fwd", bias_fwd), \
                mock.patch.object(fc, "ce_forward", ce_fwd), mock.patch.object(tdrop, "dropout_keep", keep):
            grads_of(wrapper, batch, state_a.aux, offsets, dropout_seed=77)
        n_kept = int(sum(int(x[0]) for x in kept))
        n_all = sum(x[1] for x in kept)
        rate = n_kept / n_all
        sd = math.sqrt(0.9 * 0.1 / n_all)
        q, k, v, table, n_head, nk, causal = captured["bias"]
        hd = q.shape[-1] // n_head
        zero_tokens = (q.view(q.shape[0], q.shape[1], -1) == 0).all(-1).float().mean().item()
        print(f"[4] one training forward of the trained model with dropout: {len(kept)} masks drawn on the card, "
              f"{n_kept} of {n_all} kept = {rate:.6f} (0.9 +- 4 x {sd:.2e}: "
              f"{'ok' if abs(rate - 0.9) <= 4 * sd else 'FAIL'}); the first layer's q has {zero_tokens:.4f} of "
              f"its tokens dropped whole", flush=True)
        if abs(rate - 0.9) > 4 * sd or not 0.05 < zero_tokens < 0.15:
            raise AssertionError("the card's dropout masks do not keep 0.9")
        print("[4] the kernels of this path against their plain versions on the dropped-out inputs of this run:",
              flush=True)
        bias_errs = compare_flash_bias(fa, q.shape[0], q.shape[1], n_head, hd, 1, q.dtype, causal, nk,
                                       inputs=(q, k, v, table))
        q16, c16, cv, lq, s_ce, beta = captured["ce"]
        ce_errs, ce_tols = compare_ce(fc, q16.shape[0], s_ce, q16.shape[1], beta, "roll", inputs=(q16, c16, cv, lq))
        del captured, q, k, v, table, q16, c16, cv, lq

        # remat on against remat off, with dropout
        check = request_batch(4747, PROD_CHECK_BATCH, TRAINER_HISTORY)
        loss_on, grads_on = grads_of(wrapper, check, state_a.aux, offsets, dropout_seed=78)
        stack = wrapper.module.query_tower.transformer
        stack.remat = False
        remat_off = grads_of(wrapper, check, state_a.aux, offsets, dropout_seed=78)
        stack.remat = True
        bits = remat_off[0] == loss_on and all(torch.equal(grads_on[n], remat_off[1][n]) for n in grads_on)
        remat_err = held_to("lthm_train.yaml's model with dropout, remat on vs off", remat_off, grads_on, loss_on,
                            2**-5, 2**-8 * abs(loss_on), f"the production path's bf16 tolerances; the same bits: {bits}")
        del wrapper, state_a, grads_on, remat_off
        torch.cuda.empty_cache()

        # debug_numerics on lthm_tiny (2 layers; the mode syncs on every op)
        tiny = main_training.load_config(main_training.CONFIG_ROOT / "lthm_tiny.yaml",
                                         overrides=main_training.parse_cli_overrides(
                                             ["model.fused_ce=true", "model.transformer_config.attn_config.dropout=0.1",
                                              "model.transformer_config.attn_config.attn_dropout=0.1"]),
                                         search_paths=[str(main_training.CONFIG_ROOT)]).model
        tiny_batch = request_batch(4848, 32, tiny.context_width + 8)
        tiny_offsets = sample_offsets(torch.Generator().manual_seed(7), tiny.lookahead)
        losses = []
        for checked in (False, True):
            tw = LTHMModelWrapper(tiny, device="cuda", seed=0)
            st = TrainState.create(tw, seed=3)
            before = [kern.launches for kern in kernels]
            step = debug.checked_step(train_step) if checked else train_step
            losses.append(step(st, tiny_batch, offsets=tiny_offsets)[0].item())
            launched = {kern.name for kern, n in zip(kernels, before) if kern.launches > n}
        with torch.no_grad():
            tw.module.query_tower.transformer.block_1.c_fc.weight[0, 0] = float("nan")
        try:
            debug.checked_step(train_step)(st, tiny_batch, offsets=tiny_offsets)
            weight_error = "no error"
        except FloatingPointError as e:
            weight_error = str(e)
        o_in = torch.randn(2, 513, 512, device="cuda").to(torch.bfloat16)
        o_in[1, 7, 3] = float("nan")
        kv_in = torch.randn(2, 513, 32, device="cuda").to(torch.bfloat16)
        tab = torch.randn(2 * 513 + 1, 32, device="cuda")
        kernel_error = "no error"
        with debug.numerics_checked():
            try:
                fa.fused_flash_attention_bias_fwd(o_in, kv_in[..., :16].contiguous(), kv_in[..., 16:].contiguous(),
                                                  tab, 32, 513, True)
            except FloatingPointError as e:
                kernel_error = str(e)
        ok = (losses[0] == losses[1] and "produced by operation aten." in weight_error
              and "produced by kernel flash_bias_fwd" in kernel_error)
        print(f"[4] debug_numerics on lthm_tiny (2 layers, dropout, fused CE; kernels {sorted(launched)}): clean "
              f"step loss {losses[1]!r} checked vs {losses[0]!r} unchecked; a NaN planted in "
              f"block_1.c_fc.weight: {weight_error!r}; a NaN in flash_bias_fwd's q: {kernel_error!r} "
              f"-> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("debug_numerics did not hold")

        stages = met_b["feed_path_stages"]
        plain = [x for i, x in enumerate(turns_b, start=1) if i > 1 and i % 4]  # neither warm-up nor metrics
        waits = met_b["feed_wait_s"]
        # the first turn's wait holds the spawned reader's start and its first batch
        return {"turn_ms": [x * 1e3 for x in turns_b], "median_ms": float(np.median(plain)) * 1e3,
                "min_ms": min(plain) * 1e3, "max_ms": max(plain) * 1e3, "plain_turns": len(plain),
                "turn_a_ms": [x * 1e3 for x in met_a["step_times_s"]],
                "feed_wait_share": sum(waits[1:]) / sum(turns_b[1:]), "first_wait_ms": waits[0] * 1e3,
                "peak_mib": peak_a, "peak_b_mib": peak_b, "stages": stages, "seconds": [secs_a, secs_b, secs_c],
                "per_step": per_step, "bias_errs": bias_errs, "ce_errs": ce_errs, "ce_tols": ce_tols,
                "keep_rate": rate, "remat_err": remat_err, "remat_bits": bits}
    finally:
        strategy_log.removeHandler(handler)
        strategy_log.setLevel(old_level)
        shutil.rmtree(tmp, ignore_errors=True)
        FakeDataStore.reset()


MOE_ROTATOR = {"moe": {"num_experts": 4, "proj_features": 256, "ff_mult_factor": 4, "gate_sizes": [128], "top_k": 2}}


def moe_config() -> dict:
    """The production LTHM at lthm.yaml's own context 512 (16 layers, remat,
    d=512, MQA 32x16, the bias window 513, fused_ce on) with only its
    rotator replaced by an MoE one: a gate layer of 128, top-2 of 4 experts
    of 256, the FFN width 4 x 512."""
    d = production_config(CTX512)
    d["transformer_config"]["rotator_config"] = json.loads(json.dumps(MOE_ROTATOR))
    return d


def random_bias_tables(wrapper, seed) -> int:
    """The position-bias tables start at zeros: random bf16 values, so a
    bias kernel that ignored the table or read the wrong rows would show.
    Returns the number of tables."""
    from recommendations_tpu_torch.nn.attention import RelativePositionBias

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tables = [m.bias for m in wrapper.module.modules() if isinstance(m, RelativePositionBias)]
    with torch.no_grad():
        for table in tables:
            table.copy_(torch.randn(table.shape, generator=gen, device="cuda").to(torch.bfloat16))
    return len(tables)


def moe_path(fa, fc, kernels):
    """Phases [3] and [4] on the MoE LTHM (``moe_config``, T = 513, random
    position-bias tables): a warm-up and PROD_REQUESTS requests of 64 users
    (16 bias forwards a request), a warm-up and PROD_STEPS timed steps of 64
    users (16 of each bias kernel and 12 of each CE kernel a step), every
    launch count set to 0 just before and read just after; one step's
    gradients at PROD_CHECK_BATCH users, the expert stacks and gates
    included, against the plain bias attention; remat on against off; a
    small float32 MoE model on the card against the CPU. Returns numbers
    for phase [5]."""
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.nn.transformer import MoELinear
    from recommendations_tpu_torch.train.train_state import TrainState

    cfg = LTHMModelConfig.from_dict(moe_config())
    layers, heads, chunks = cfg.transformer_config.num_layers, len(cfg.lookahead), BATCH // cfg.train_mini_batch_size
    wrapper = LTHMModelWrapper(cfg, device="cuda", seed=0)
    moes = [m for m in wrapper.module.modules() if isinstance(m, MoELinear)]
    if len(moes) != 2 * layers:
        raise AssertionError(f"{len(moes)} MoELinear in {layers} layers")
    random_bias_tables(wrapper, 8)
    n_params = sum(p.numel() for p in wrapper.module.parameters())
    print(f"[3] MoE LTHM (lthm.yaml at context {CTX512}, rotator {MOE_ROTATOR['moe']}): {n_params} parameters",
          flush=True)
    models = wrapper.inference_models()
    events = CTX512 + 8
    models["user_encoder"](request_batch(700, BATCH, events))  # warm-up
    requests = [request_batch(seed, BATCH, events) for seed in range(701, 701 + PROD_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    request_ms = []
    for batch in requests:
        t0 = time.perf_counter()
        emb = models["user_encoder"](batch)["user_emb"]
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        if tuple(emb.shape) != (BATCH, cfg.product_tower.product_emb_dim) or not bool(torch.isfinite(emb).all()):
            raise AssertionError("MoE user_emb: wrong shape or not finite")
        if (emb.norm(dim=-1) - 1).abs().max().item() > 1e-4:
            raise AssertionError("MoE user_emb is not unit-norm")
    serve_counts = {kern.name: kern.launches for kern in kernels}
    serve_peak = torch.cuda.max_memory_allocated() / 2**20
    want = {kern.name: (layers * PROD_REQUESTS if kern is fa.FLASH_BIAS_FWD else 0) for kern in kernels}
    print(f"[3] {PROD_REQUESTS} MoE requests of {BATCH} users ({events} events, T = {CTX512 + 1}): launches "
          f"{serve_counts} (expected {want})", flush=True)
    if serve_counts != want:
        raise AssertionError("the MoE requests did not launch the bias forward once a layer")
    del models

    state = TrainState.create(wrapper, seed=1)
    batch = request_batch(2700, BATCH, events)
    offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
    train = timed_train("MoE LTHM, context 512 (fused bias kernels at T = 513, fused CE)", state, batch, offsets,
                        PROD_STEPS, kernels,
                        {"flash_bias_fwd": layers, "flash_bias_dq": layers, "flash_bias_dkv": layers,
                         **{k.name: heads * chunks for k in fc.KERNELS}})

    # one step's gradients against the plain bias attention: with the top-2
    # routing, and with the same weights mixing every expert (top_k off)
    check = request_batch(2701, PROD_CHECK_BATCH, events)

    def against_plain():
        loss, grads = grads_of(wrapper, check, state.aux, offsets)
        before = [kern.launches for kern in kernels]
        with mock.patch.object(fa, "fused_flash_attention_bias_fwd", fa.fused_flash_attention_bias_reference), \
                mock.patch.object(fa, "fused_flash_attention_bias_bwd", fa.fused_flash_attention_bias_bwd_reference):
            plain = grads_of(wrapper, check, state.aux, offsets)
        if [kern.launches for kern in kernels[:5]] != before[:5]:
            raise AssertionError("the plain bias attention run launched a flash kernel")
        return loss, grads, plain

    for k in ("moe_fc.w1", "moe_fc.b1", "moe_fc.gate_0.weight", "moe_proj.w2", "moe_proj.gate_out.weight"):
        if not any(n.endswith(k) for n, p in wrapper.module.named_parameters() if p.requires_grad):
            raise AssertionError(f"the MoE model has no parameter {k}")
    for m in moes:
        m.top_k = None
    loss_s, grads_s, plain = against_plain()
    plain_err = held_to(
        "MoE LTHM with every expert mixed (top_k off), kernel vs plain bias attention", plain, grads_s, loss_s,
        2**-5, 2**-8 * abs(loss_s),
        f"one-ulp flips in o, dq, dk, dv travel through {layers} layers of bf16 products: 2**-5 (four ulps), the "
        "loss 2**-8 relative; the expert stacks, the gate layers and the position-bias tables included")
    for m in moes:
        m.top_k = MOE_ROTATOR["moe"]["top_k"]
    loss_k, grads_k, plain = against_plain()
    routed_err = held_to(
        "MoE LTHM with its top-2 routing, kernel vs plain bias attention", plain, grads_k, loss_k, 2**-2,
        2**-8 * abs(loss_k),
        "top-k by threshold is a step function of the gates: a token whose 2nd and 3rd gates lie within a bf16 "
        "ulp takes another expert pair on the other path and moves every gradient by a few percent (about 9% "
        "at worst, a gate layer); 2**-2, which a gradient of the wrong sign or scale fails")
    del plain, grads_s
    stack = wrapper.module.query_tower.transformer
    stack.remat = False
    off = grads_of(wrapper, check, state.aux, offsets)
    stack.remat = True
    same = off[0] == loss_k and all(torch.equal(grads_k[n], off[1][n]) for n in grads_k)
    print(f"[4] MoE LTHM, remat on vs off: loss {loss_k:.6f} vs {off[0]:.6f}, every gradient the same bits "
          f"{same} -> {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError("remat changed the MoE gradients")
    del grads_k, off, state, wrapper
    torch.cuda.empty_cache()

    # a small float32 MoE model: the card against the CPU
    small = bench_config()
    small.update(compute_dtype="float32", context_width=48, lookahead=[0, 2, 4], train_mini_batch_size=3,
                 log_q_config={"num_buckets": 4096, "hash_offsets": [0, 7]})
    small["transformer_config"].update(num_layers=2, rotator_config={"moe": {
        "num_experts": 3, "proj_features": 16, "ff_mult_factor": 2, "gate_sizes": [8], "top_k": 2}})
    small["transformer_config"]["attn_config"].update(n_head=4, n_embd=64)
    small["product_tower"].update(out_emb_dim=64, product_emb_dim=32, inp_emb_dim=16)
    small["product_tower"]["latent_model_config"]["vocab_size_latent"] = 5000
    small_cfg = LTHMModelConfig.from_dict(small)
    on_card = LTHMModelWrapper(small_cfg, device="cuda", seed=3)
    on_cpu = LTHMModelWrapper(small_cfg, device="cpu")
    on_cpu.module.load_state_dict({k: v.cpu() for k, v in on_card.module.state_dict().items()})
    sb = request_batch(97, batch=4, events=56)
    small_offsets = sample_offsets(torch.Generator().manual_seed(3), small_cfg.lookahead)
    a = on_card.inference_models()["user_encoder"](sb)["user_emb"].cpu()
    b = on_cpu.inference_models()["user_encoder"](sb)["user_emb"]
    small_err = (a - b).abs().max().item()
    lc, gc = grads_of(on_card, sb, on_card.init_aux_state(), small_offsets)
    lp, gp = grads_of(on_cpu, sb, on_cpu.init_aux_state(), small_offsets)
    worst = max((rel_err(gc[n].cpu(), gp[n]) / (2**-8 if ".direction_emb_" in n else 2e-4), n) for n in gp)
    ok = small_err <= 1e-4 and abs(lc - lp) <= 1e-4 and set(gc) == set(gp) and worst[0] <= 1
    print(f"[4] small f32 MoE model, card vs CPU: user_emb max|err| {small_err:.3e} (tol 1e-04); loss {lc:.6f} vs "
          f"{lp:.6f} (tol 1e-04); worst gradient {worst[1]} at {worst[0]:.3f} of its tolerance (2e-4 norm-relative, "
          f"the LSH tables one bf16 ulp) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the card and the CPU disagree on the small MoE model")
    return {"request_ms": request_ms, "request_median_ms": float(np.median(request_ms)), "serve_peak_mib": serve_peak,
            "serve_counts": serve_counts, "train": train, "plain_err": plain_err, "routed_err": routed_err}


SPARSE_FACTOR = 0.5


def sparse_config() -> dict:
    """The long-history path (``longseq_config``: LTHM-base widths, remat, no
    position bias, context 1024, T = 1025) with the seeded sparse keep-sets:
    each block attends over int(0.5 * 1025) = 512 of the 1025 positions."""
    d = longseq_config()
    d["transformer_config"].update(is_sparse_attn=True, sparsity_factor=SPARSE_FACTOR, max_block_size=LONG_CONTEXT + 1)
    return d


def sparse_long_history(fa, kernels):
    """Phases [3] and [4] on the sparse long-history path (``sparse_config``,
    16 users): a warm-up and LONG_REQUESTS requests (6 flash_fwd each, at
    T = 512), a warm-up and LONG_STEPS timed steps (6 flash_fwd and 6
    flash_bwd a step, at T = 512), every launch count set to 0 just before
    and read just after; the served outputs and one step's gradients against
    the plain attention; the first block's skipped positions equal
    x + null_connector(x). Returns numbers for phase [5]."""
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.train.train_state import TrainState

    cfg = LTHMModelConfig.from_dict(sparse_config())
    layers = cfg.transformer_config.num_layers
    kept = int(SPARSE_FACTOR * (LONG_CONTEXT + 1))
    wrapper = LTHMModelWrapper(cfg, device="cuda", seed=0)
    events = LONG_CONTEXT + 8
    models = wrapper.inference_models()
    seen_t = []
    fwd, bwd = fa.fused_flash_attention_fwd, fa.fused_flash_attention_bwd

    def recording_fwd(q, *args, **kw):
        seen_t.append(q.shape[1])
        return fwd(q, *args, **kw)

    def recording_bwd(q, *args, **kw):
        seen_t.append(-q.shape[1])
        return bwd(q, *args, **kw)

    with mock.patch.object(fa, "fused_flash_attention_fwd", recording_fwd):
        models["user_encoder"](request_batch(800, LONG_BATCH, events))  # warm-up
    print(f"[3] sparse long-history LTHM ({layers} layers, remat, context {cfg.context_width}, keep-sets of "
          f"{SPARSE_FACTOR} x {LONG_CONTEXT + 1}): attention at T = {sorted(set(seen_t))}", flush=True)
    if set(seen_t) != {kept}:
        raise AssertionError(f"the sparse blocks did not attend over their {kept} kept positions")
    requests = [request_batch(seed, LONG_BATCH, events) for seed in range(801, 801 + LONG_REQUESTS)]
    torch.cuda.synchronize()
    for kern in kernels:
        kern.launches = 0
    request_ms = []
    for batch in requests:
        t0 = time.perf_counter()
        emb = models["user_encoder"](batch)["user_emb"]
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t0) * 1e3)
        if tuple(emb.shape) != (LONG_BATCH, cfg.product_tower.product_emb_dim) or not bool(torch.isfinite(emb).all()):
            raise AssertionError("sparse user_emb: wrong shape or not finite")
        if (emb.norm(dim=-1) - 1).abs().max().item() > 1e-4:
            raise AssertionError("sparse user_emb is not unit-norm")
    serve_counts = {kern.name: kern.launches for kern in kernels}
    want = {kern.name: (layers * LONG_REQUESTS if kern is fa.FLASH_FWD else 0) for kern in kernels}
    print(f"[3] {LONG_REQUESTS} sparse long-history requests of {LONG_BATCH} users: launches {serve_counts} "
          f"(expected {want})", flush=True)
    if serve_counts != want:
        raise AssertionError("the sparse requests did not launch flash_fwd once a layer")

    def plain_attention(q, k, v, n_head, causal=True):
        return fa.fused_flash_attention_reference(q, k, v, n_head, causal)[0]

    check = request_batch(850, LONG_BATCH, events)
    seq = models["sequence_encoder"](check)["next_token_emb"]
    with mock.patch.object(fa, "fused_flash_attention", plain_attention):
        seq_plain = models["sequence_encoder"](check)["next_token_emb"]
    max_err, max_tol = (seq - seq_plain).abs().max().item(), 2**-6 * seq_plain.abs().max().item()
    mean_err, mean_tol = (seq - seq_plain).abs().mean().item(), 2**-8 * seq_plain.abs().mean().item()
    ok = max_err <= max_tol and mean_err <= mean_tol
    print(f"[3] sparse sequence_encoder, kernel vs plain attention: max|err| {max_err:.3e} (tol {max_tol:.3e}), "
          f"mean|err| {mean_err:.3e} (tol {mean_tol:.3e}), held as LTHM-base -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the sparse kernel path and the plain-attention path disagree")

    # the first block's skipped positions: x + null_connector(x) of its input
    block = wrapper.module.query_tower.transformer.block_0
    seen = {}
    hook = block.register_forward_hook(lambda m, args, out: seen.update(x=args[0], out=out))
    models["sequence_encoder"](check)
    hook.remove()
    not_idx = torch.as_tensor(block.keep[1], device="cuda")
    with torch.no_grad():
        skipped = seen["x"].index_select(1, not_idx)
        want_skipped = skipped + block.null_connector(skipped)
    same = torch.equal(seen["out"].index_select(1, not_idx), want_skipped)
    print(f"[3] sparse block 0: its {not_idx.numel()} skipped positions equal x + null_connector(x) "
          f"{same} -> {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError("the skipped positions are not x + null_connector(x)")
    del models, seen

    state = TrainState.create(wrapper, seed=1)
    batch = request_batch(3100, LONG_BATCH, events)
    offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
    seen_t.clear()
    with mock.patch.object(fa, "fused_flash_attention_fwd", recording_fwd), \
            mock.patch.object(fa, "fused_flash_attention_bwd", recording_bwd):
        loss_k, grads_k = grads_of(wrapper, batch, state.aux, offsets)
    if set(seen_t) != {kept, -kept}:
        raise AssertionError(f"the sparse step's attention ran at {sorted(set(seen_t))}, not T = {kept}")
    with mock.patch.object(fa, "fused_flash_attention_fwd", fa.fused_flash_attention_reference), \
            mock.patch.object(fa, "fused_flash_attention_bwd", fa.fused_flash_attention_bwd_reference):
        plain = grads_of(wrapper, batch, state.aux, offsets)
    if not any(n.endswith("null_connector.weight") for n in grads_k):
        raise AssertionError("no gradient reached the null connectors")
    plain_err = held_to("sparse long-history, kernel vs plain attention", plain, grads_k, loss_k, 2**-5,
                        2**-8 * abs(loss_k), f"as LTHM-base: one-ulp flips through {layers} layers of bf16 products")
    del plain, grads_k
    train = timed_train(f"sparse long-history (T = {kept} a block, remat, eager CE)", state, batch, offsets,
                        LONG_STEPS, kernels, {"flash_fwd": layers, "flash_bwd": layers})
    del state, wrapper
    torch.cuda.empty_cache()
    return {"request_ms": request_ms, "request_median_ms": float(np.median(request_ms)), "serve_counts": serve_counts,
            "train": train, "kept": kept, "plain_err": plain_err, "max_err": max_err}


RANKER_STEPS, RANKER_ROWS_PER_FILE = 20, 4096  # ranker_train.yaml's 200 steps cut to 20
LEARN_STEPS = 120


def ranker_batch(config, seed, n):
    """``n`` rows of the port's make_ranking_log through the config's feature
    pipeline, as the trainer's loader gives them."""
    from recommendations_tpu_torch.tools.synth_data import make_ranking_log

    table = config.features.default_data_mapper(make_ranking_log(num_rows=n, seed=seed))
    return {k: np.asarray(v) for k, v in table.items() if np.asarray(v).dtype != object}


def ranker_path(kernels):
    """Phase [4] on the ranker: main_training on configs/ranker_train.yaml at
    its own widths (ranker.yaml), on the port's synth ranking logs in the
    in-memory store, for RANKER_STEPS steps (the YAML's 200 cut to 20) with
    validation (the YAML's 4 batches) and a checkpoint every 10 steps and a
    jsonl tracker, and the YAML's batch inference after training (a score
    per validation impression and task in the export). The launch counts are set to 0 before the run and read after:
    the ranker launches no kernel of the port (its products are plain
    matmuls, as the JAX package computes them outside Pallas). Then a run
    resumed from step 10 ends on the same bits; one train_step from two
    wrappers of one seed gives the same bits; the export reloads in a fresh
    wrapper and scores the same; and a learning check mirroring
    tests/test_ranker.py::test_ranker_learns_signal (Adam 3e-3, 120 steps over
    4 cycled batches of 256) reaches train AUC > 0.6. Returns numbers for
    phase [5]."""
    import tempfile

    from recommendations_tpu_torch import main_training
    from recommendations_tpu_torch.data.data_store import FakeDataStore
    from recommendations_tpu_torch.models.ranker.config import RankerModelConfig
    from recommendations_tpu_torch.models.ranker.wrapper import RankerModelWrapper
    from recommendations_tpu_torch.pipeline.export import load_exported_wrapper
    from recommendations_tpu_torch.tools.synth_data import write_ranking_dataset
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState

    FakeDataStore.reset()
    write_ranking_dataset(None, ["20240101", "20240102"], files_per_date=2, rows_per_file=RANKER_ROWS_PER_FILE,
                          fake_store=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranker_")
    try:
        def run(tag, ckpt_dir):
            argv = ["--config-name", "ranker_train", "dataset.filesystem_config.kind=fake",
                    f"train.train_steps={RANKER_STEPS}", "train.val_metrics_every_n_steps=10",
                    "train.checkpoint_every_k_steps=10", f"checkpoint_dir={ckpt_dir}",
                    f"export.filesystem_config.local_dir_prefix={tmp}/export_{tag}",
                    f"trackers.trackers=[{{kind: jsonl, path: {tmp}/{tag}.jsonl}}]", f"model_version={tag}",
                    f"run_id=chip_smoke_{tag}"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kern in kernels:
                kern.launches = 0
            t1 = time.perf_counter()
            pipeline, metrics = main_training.main(argv, return_pipeline=True)
            torch.cuda.synchronize()
            counts = {kern.name: kern.launches for kern in kernels}
            return pipeline, metrics, counts, torch.cuda.max_memory_allocated() / 2**20, time.perf_counter() - t1

        pipe_a, met_a, counts_a, peak_a, secs_a = run("a", f"{tmp}/ckpt_a")
        wrapper, state_a = pipe_a._trained
        cfg = wrapper.config
        n_params = sum(p.numel() for p in wrapper.module.parameters())
        batch_size = cfg_batch(pipe_a)
        print(f"[4] main_training on ranker_train.yaml (ranker.yaml: emb_dim {cfg.emb_dim}, towers "
              f"{list(cfg.tower_hidden)}, top {list(cfg.top_hidden)}, {cfg.num_embeddings_default}-row QR tables, "
              f"{len(cfg.task_list)} tasks, {n_params} parameters; {RANKER_STEPS} steps of {batch_size}, cut from "
              f"the YAML's 200): launches {counts_a} (the ranker's products are plain matmuls)", flush=True)
        if any(counts_a.values()):
            raise AssertionError("the ranker launched a kernel of the LTHM path")
        import pyarrow.parquet as pq

        scores = pq.read_table(os.path.join(pipe_a.export_dir(), "inference", "inference_results.parquet"))
        score_cols = [f"ranker_scorer.{t.name}" for t in cfg.task_list]
        print(f"[4] the ranker's batch inference: {scores.num_rows} validation impressions scored, columns "
              f"{scores.column_names}", flush=True)
        if scores.num_rows != 2 * RANKER_ROWS_PER_FILE or not set(score_cols) <= set(scores.column_names):
            raise AssertionError("the ranker's batch inference did not score every validation impression")
        if not isinstance(wrapper, RankerModelWrapper) or state_a.step != RANKER_STEPS:
            raise AssertionError(f"the ranker trainer stopped at step {state_a.step}")
        with open(f"{tmp}/a.jsonl") as f:
            lines = [r["metrics"] for r in map(json.loads, f) if r["event"] == "metrics"]
        train_lines = [m for m in lines if "train_loss" in m]
        val_lines = [m for m in lines if "val_loss" in m]
        tasks = [t.name for t in cfg.task_list]
        want_train = ({f"train_{k}_{t}" for k in ("auc", "pos_rate", "loss") for t in tasks}
                      | {"train_loss", "grad_norm", "params_nan", "training speed - samples per second", "epoch",
                         "steps"})
        want_val = ({f"val_{k}_{t}" for k in ("auc", "pos_rate", "loss") for t in tasks}
                    | {"val_loss", "val_batches_skipped_nan", "eval speed - samples per second", "RAM Available - GB"})
        if [m["steps"] for m in train_lines] != [10, 20] or len(val_lines) != 2:
            raise AssertionError(f"ranker jsonl: train lines at {[m.get('steps') for m in train_lines]}, "
                                 f"{len(val_lines)} validation lines")
        for m in train_lines:
            if set(m) != want_train:
                raise AssertionError(f"ranker jsonl train keys differ: {sorted(set(m) ^ want_train)}")
        for m in val_lines:
            if set(m) != want_val:
                raise AssertionError(f"ranker jsonl val keys differ: {sorted(set(m) ^ want_val)}")
        losses = [m[k] for m in lines for k in m if k.endswith("_loss")]
        if not np.isfinite(losses).all():
            raise AssertionError(f"a logged ranker loss is not finite: {losses}")
        print(f"[4] ranker jsonl: {len(train_lines)} train and {len(val_lines)} validation lines under the JAX "
              f"package's keys; train_loss {[round(m['train_loss'], 5) for m in train_lines]}, val_loss "
              f"{[round(m['val_loss'], 5) for m in val_lines]}, val AUC click "
              f"{[round(m['val_auc_click'], 4) for m in val_lines]}", flush=True)

        os.makedirs(f"{tmp}/ckpt_b")
        shutil.copy(f"{tmp}/ckpt_a/step_00000010.pt", f"{tmp}/ckpt_b/step_00000010.pt")
        pipe_b, _, _, _, secs_b = run("b", f"{tmp}/ckpt_b")
        state_b = pipe_b._trained[1]
        sa, sb = state_a.state_dict(), state_b.state_dict()
        differ = [n for n, t in sa["module"].items() if not torch.equal(t, sb["module"][n])]
        for i, (oa, ob) in enumerate(zip(sa["optimizers"], sb["optimizers"])):
            for pid, st in oa["state"].items():
                differ += [f"optimizer{i}.{pid}.{k}" for k, t in st.items()
                           if torch.is_tensor(t) and not torch.equal(t, ob["state"][pid][k])]
        print(f"[4] ranker resumed from the step-10 checkpoint, steps 11-{RANKER_STEPS} again: "
              f"{'bit-equal to the uninterrupted run' if not differ else 'DIFFERS: ' + ', '.join(differ[:8])}",
              flush=True)
        if differ or state_b.step != RANKER_STEPS:
            raise AssertionError("the resumed ranker run differs from the uninterrupted run")
        del pipe_b, state_b, sb

        # one step from two wrappers of one seed: the same bits (duplicate QR rows summed in a fixed order)
        batch = ranker_batch(cfg, 11, batch_size)
        after = []
        for _ in range(2):
            w = RankerModelWrapper(cfg, device="cuda", seed=5)
            st = TrainState.create(w, pipe_a.pipeline_config.train)
            train_step(st, batch)
            after.append({n: p.detach().clone() for n, p in w.module.named_parameters()})
        repeat_same = all(torch.equal(after[0][n], after[1][n]) for n in after[0])
        print(f"[4] ranker, one train_step from two wrappers of one seed: every parameter the same bits "
              f"{repeat_same} -> {'ok' if repeat_same else 'FAIL'}", flush=True)
        if not repeat_same:
            raise AssertionError("two ranker steps from the same state gave different bits")
        del after

        export_dir = pipe_a.export_dir()
        fresh = load_exported_wrapper(export_dir, device="cuda")
        score_batch = ranker_batch(cfg, 12, batch_size)
        want = wrapper.inference_models()["ranker_scorer"](score_batch)
        got = fresh.inference_models()["ranker_scorer"](score_batch)
        same = isinstance(fresh, RankerModelWrapper) and all(torch.equal(want[k], got[k]) for k in want)
        print(f"[4] ranker export ({export_dir}) loaded into a fresh {type(fresh).__name__}: ranker_scorer on "
              f"{batch_size} rows {'bit-equal to the trained model' if same else 'DIFFERS'}", flush=True)
        if not same:
            raise AssertionError("the exported ranker scores otherwise than the trained one")
        del fresh

        # the learning check of tests/test_ranker.py at its config, on the card
        learn_cfg = RankerModelConfig.from_dict(dict(
            emb_dim=16, tower_hidden=[32], tower_dim=16, top_hidden=[32], num_embeddings_default=10007, lr=3e-3,
            tasks=[{"name": "click", "kind": "numerical", "num_labels": 1, "weight": 1.0}],
            features={
                "defaults": {"categorical_features": {"default_dtype": "string", "transform_value_to_lowercase": False,
                                                      "value_to_number_mapper": {"kind": "xxhash"}}},
                "categorical_features": [
                    {"name": "product_id", "kind": "categorical", "tower_name": "product"},
                    {"name": "customer_id", "kind": "categorical", "tower_name": "user"},
                    {"name": "search_query", "kind": "categorical", "tower_name": "query"}],
                "numerical_features": [
                    {"name": "price", "kind": "numerical", "tower_name": "product"},
                    {"name": "position", "kind": "numerical", "tower_name": "query"},
                    {"name": "click", "kind": "numerical", "tower_name": "other"}],
                "bool_features": [{"name": "is_returning_user", "kind": "bool", "tower_name": "user"}],
                "timestamp_features": [{"name": "event_ts", "kind": "timestamp", "tower_name": "query"}],
            }))
        learner = RankerModelWrapper(learn_cfg, device="cuda", seed=0)
        lst = TrainState.create(learner, seed=2)
        batches = [ranker_batch(learn_cfg, seed, 256) for seed in range(4)]
        t1 = time.perf_counter()
        for i in range(LEARN_STEPS):
            _, metrics = train_step(lst, batches[i % 4])
        auc = float(metrics["train_auc_click"])
        learn_s = time.perf_counter() - t1
        print(f"[4] ranker learning check (tests/test_ranker.py's config, AdamW at 3e-3 without decay = Adam, "
              f"{LEARN_STEPS} steps over 4 cycled batches of 256): train AUC {auc:.4f} (must exceed 0.6), "
              f"{learn_s:.2f} s -> {'ok' if auc > 0.6 else 'FAIL'}", flush=True)
        if not auc > 0.6:
            raise AssertionError(f"the ranker did not learn: train AUC {auc}")

        turns = met_a["step_times_s"]
        plain = [x for i, x in enumerate(turns, start=1) if i > 1 and i % 10]
        stages = met_a["feed_path_stages"]
        wait = stages.get("step.next_batch_wait", {}).get("total_s", 0.0)
        direct_ms = []
        for _ in range(5):
            t1 = time.perf_counter()
            train_step(state_a, batch)
            torch.cuda.synchronize()
            direct_ms.append((time.perf_counter() - t1) * 1e3)
        return {"turn_ms": [x * 1e3 for x in turns], "median_ms": float(np.median(plain)) * 1e3,
                "plain_turns": len(plain), "peak_mib": peak_a, "feed_wait_share": wait / sum(turns),
                "seconds": secs_a, "resume_seconds": secs_b, "batch": batch_size, "auc": auc,
                "direct_ms": direct_ms, "n_params": n_params}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        FakeDataStore.reset()


PIPE_STEPS = 4  # lthm_train.yaml's 20000 steps cut to 4
PIPE_KNN_BATCHES = 2  # eval.max_eval_steps: the KNN eval's query batches of 32 users
PIPE_CATALOG = 1_500_000  # string product ids: two chunks of knn_catalog_chunk_rows = 1 << 20
PIPE_PRODUCTS = 200_000  # the compression job's input table
PIPE_RECON_EPOCHS, PIPE_MASK_EPOCHS = 3, 2  # the job's 50 and 20 cut
PIPE_INFER_PASSES = 5  # run_inference passes over the val stream, timed one by one
TIE_EPS = 1e-6  # scores of unit vectors this close rank either way between two products
PROGRAM_SCRIPT = r"""
import json, statistics, sys, time
import torch
root, export, trace_path, out_path = sys.argv[1:5]
sys.path.insert(0, root)
import recommendations_tpu_torch.ops
from recommendations_tpu_torch.ops import fused_attention as fa

batch = torch.load(trace_path)
variables = torch.load(export + "/params/state_dict.pt", map_location="cuda")
res, outs = {}, {}
for name in ("user_encoder", "sequence_encoder"):
    program = torch.export.load(export + "/" + name + ".pt2").module()
    before = fa.FLASH_BIAS_FWD.launches
    with torch.no_grad():
        out = program(variables, batch)
    torch.cuda.synchronize()
    res[name + "_launches"] = fa.FLASH_BIAS_FWD.launches - before
    outs[name] = {k: v.cpu() for k, v in out.items()}
    ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        with torch.no_grad():
            program(variables, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res[name + "_ms"] = statistics.median(ms)
res["modules"] = sorted(m for m in sys.modules if m.startswith("recommendations_tpu"))
torch.save(outs, out_path)
print(json.dumps(res))
"""


def pipeline_extras(fa, kernels, smi):
    """Phase [4] on the pipeline extras of configs/lthm_train.yaml at full
    width (16 layers, MQA 32x16 bf16, the position bias, T = 513 = the
    window, the 10M x 32 table): main_training for PIPE_STEPS steps of 64 on
    the in-memory store (2 files of 320 users, 768 events) with
    eval.skip_eval=false eval.skip_knn_eval=false inference.skip_inference=false
    export.trace=true, a catalog of PIPE_CATALOG string ids (a parquet file,
    read into the store) and one validation batch. The launch counts are set
    to 0 just before the run and read just after: 16 bias forwards a
    training step, a validation batch and a KNN query batch, 16 an inference
    batch through each entry point (user_encoder and sequence_encoder, as
    the JAX package runs both), and 16 of each bias backward kernel a step. Then: the KNN eval's
    chunked merge against one full product and torch.topk on the card, and
    its queries on the kernel route against the plain bias attention; the
    inference parquet against direct user_encoder calls, bit for bit; the
    two .pt2 programs loaded in a fresh process that imports only
    recommendations_tpu_torch.ops, against the eager wrapper bit for bit,
    each call 16 bias forwards; the compression job on PIPE_PRODUCTS
    128-wide vectors, and lthm_train.yaml on its artifact serving and
    training a step with the buffers untouched. Returns numbers for phase
    [5]."""
    import tempfile

    import pyarrow as pa
    import pyarrow.parquet as pq

    from recommendations_tpu_torch import main_training
    from recommendations_tpu_torch.config.yaml_loader import load_config, parse_cli_overrides
    from recommendations_tpu_torch.data.data_store import FakeDataStore, read_parquet_table
    from recommendations_tpu_torch.data.generator import get_data_loader_strategy
    from recommendations_tpu_torch.data.loader import get_host_dataloader
    from recommendations_tpu_torch.data.paths import get_val_data_paths
    from recommendations_tpu_torch.models.lthm.pretrained import PretrainedProductEmbedding
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.pipeline import knn_eval
    from recommendations_tpu_torch.pipeline.inference import run_inference
    from recommendations_tpu_torch.pipeline.export import program_inputs
    from recommendations_tpu_torch.tools import embedding_module_gen
    from recommendations_tpu_torch.tools.synth_data import write_synthetic_dataset
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    FakeDataStore.reset()
    try:
        write_synthetic_dataset(None, ["20240101"], files_per_date=2, users_per_file=TRAINER_USERS_PER_FILE,
                                history_len=TRAINER_HISTORY, fake_store=True)
        n_users = 2 * TRAINER_USERS_PER_FILE
        t0 = time.perf_counter()
        skus = [f"sku_{i}" for i in range(PIPE_CATALOG)]
        pq.write_table(pa.table({"product_id": skus}), f"{tmp}/catalog.parquet")
        FakeDataStore.put_table("catalog/products.parquet", read_parquet_table(f"{tmp}/catalog.parquet"))
        catalog_write_s = time.perf_counter() - t0
        argv = ["--config-name", "lthm_train", "datestr=20240101", "dataset.filesystem_config.kind=fake",
                f"train.train_steps={PIPE_STEPS}", "train.validation_steps=1",
                f"train.val_metrics_every_n_steps={PIPE_STEPS}", f"train.train_metrics_every_n_steps={PIPE_STEPS}",
                "eval.skip_eval=false", "eval.skip_knn_eval=false", "inference.skip_inference=false",
                "export.trace=true", "eval.knn_catalog_table_path=catalog/products.parquet",
                f"eval.max_eval_steps={PIPE_KNN_BATCHES}", f"export.filesystem_config.local_dir_prefix={tmp}/export",
                f"trackers.trackers=[{{kind: jsonl, path: {tmp}/p.jsonl}}]", "model_version=pipe",
                "run_id=chip_smoke_pipe"]
        export_calls = {"trace": [], "save": []}

        def clocked(fn, kind):  # the export's torch.export.export and .save calls, timed
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                result = fn(*args, **kwargs)
                export_calls[kind].append(time.perf_counter() - t0)
                return result
            return run

        torch.cuda.synchronize()
        for kern in kernels:
            kern.launches = 0
        t1 = time.perf_counter()
        with mock.patch.object(torch.export, "export", clocked(torch.export.export, "trace")), \
                mock.patch.object(torch.export, "save", clocked(torch.export.save, "save")):
            pipe, metrics = main_training.main(argv, return_pipeline=True)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t1
        counts = {kern.name: kern.launches for kern in kernels}
        wrapper, state = pipe._trained
        cfg = pipe.pipeline_config
        layers = cfg.model.transformer_config.num_layers
        infer_batches = -(-n_users // cfg.inference.inference_batch_size)
        entries = len(wrapper.inference_models())  # each runs its forward on every inference batch, as JAX's
        want = {kern.name: 0 for kern in kernels}
        want.update({"flash_bias_fwd": layers * (PIPE_STEPS + 1 + PIPE_KNN_BATCHES + entries * infer_batches),
                     "flash_bias_dq": layers * PIPE_STEPS, "flash_bias_dkv": layers * PIPE_STEPS})
        print(f"[4] main_training on lthm_train.yaml with the KNN eval, the batch inference and the traced export "
              f"({PIPE_STEPS} steps of {cfg_batch(pipe)}, 1 validation batch, {PIPE_KNN_BATCHES} KNN query batches "
              f"of {cfg.eval.eval_batch_size}, {infer_batches} inference batches of {cfg.inference.inference_batch_size}"
              f"; the catalog parquet of {PIPE_CATALOG} ids written and read in {catalog_write_s:.1f} s): launches "
              f"{counts} (expected {want}: {layers} bias forwards a step, a validation and a KNN query batch, and an "
              f"inference batch through each of the {entries} entry points; the trace launches none); the run "
              f"{out['seconds']:.1f} s", flush=True)
        if counts != want or state.step != PIPE_STEPS:
            raise AssertionError("the pipeline's steps, eval and inference did not launch the bias kernels as expected")
        out.update(counts=counts, layers=layers)
        export_dir = pipe.export_dir()
        for f in ("knn_eval.csv", "inference/inference_results.parquet", "user_encoder.pt2", "sequence_encoder.pt2"):
            if not os.path.exists(os.path.join(export_dir, f)):
                raise AssertionError(f"the pipeline's export lacks {f}")
        with open(os.path.join(export_dir, "knn_eval.csv")) as f:
            csv_rows = f.read().splitlines()

        # -- the KNN eval: its time and recall, the two routes
        t1 = time.perf_counter()
        rows = knn_eval.run_knn_eval(wrapper, cfg)
        torch.cuda.synchronize()
        out["knn_s"] = time.perf_counter() - t1
        out["recall"] = {r["k"]: r["recall"] for r in rows}
        if csv_rows != ["k,recall,queries"] + [f"{r['k']},{r['recall']},{r['queries']}" for r in rows]:
            raise AssertionError(f"knn_eval.csv {csv_rows} differs from a second run's {rows}")
        feats = cfg.model.features
        strategy = get_data_loader_strategy(cfg.data_loader, feats.get_input_columns(),
                                            lambda kind: feats.default_data_mapper)
        query = next(iter(get_host_dataloader("val", 0, get_val_data_paths(cfg.dataset), cfg.eval.eval_batch_size,
                                              PIPE_KNN_BATCHES, strategy, feats, cfg.dataset.filesystem_config)))
        t1 = time.perf_counter()
        cat_ids = knn_eval.load_catalog_ids(cfg)
        hash_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        cat_emb = knn_eval.encode_catalog(wrapper, cat_ids)
        torch.cuda.synchronize()
        out["encode_ms_per_8192"] = (time.perf_counter() - t1) * 1e3 * 8192 / len(cat_ids)
        max_k = max(cfg.eval.knn_top_k_list)
        before = fa.FLASH_BIAS_FWD.launches
        qe, _, _ = knn_eval.knn_query(wrapper, query)
        torch.cuda.synchronize()
        out["knn_query_launches"] = fa.FLASH_BIAS_FWD.launches - before
        v_c, i_c = knn_eval.chunked_topk(
            qe, knn_eval._catalog_chunks(cat_emb, cat_ids, cfg.eval.knn_catalog_chunk_rows, wrapper.device), max_k)
        v_1, idx_1 = (qe @ torch.from_numpy(cat_emb).cuda().T).topk(max_k, dim=1)
        v = v_1.cpu().numpy()
        # v descends along a row: a score more than TIE_EPS from both neighbours is not tied
        untied = (-np.diff(v, axis=1, prepend=np.inf) > TIE_EPS) & (-np.diff(v, axis=1, append=-np.inf) > TIE_EPS)
        ids_1 = cat_ids[idx_1.cpu().numpy()]
        id_miss = int((i_c.cpu().numpy() != ids_1)[untied].sum())
        score_err = (v_c - v_1).abs().max().item()

        def plain_bias(q, k, v, table, n_head, nk, causal=True):
            return fa.fused_flash_attention_bias_reference(q, k, v, table, n_head, nk, causal)[0]

        with mock.patch.object(fa, "fused_flash_attention_bias", plain_bias):
            before = fa.FLASH_BIAS_FWD.launches
            qe_plain, _, _ = knn_eval.knn_query(wrapper, query)
            if fa.FLASH_BIAS_FWD.launches != before:
                raise AssertionError("the plain bias attention query launched the kernel")
        q_err, q_mean = (qe - qe_plain).abs().max().item(), (qe - qe_plain).abs().mean().item()
        q_tol, q_mean_tol = 2**-6 * qe_plain.abs().max().item(), 2**-8 * qe_plain.abs().mean().item()
        out.update(knn_id_miss=id_miss, knn_score_err=score_err, knn_query_err=q_err, knn_query_tol=q_tol)
        print(f"[4] {smi}: the KNN eval (a second run, {len(cat_ids)} catalog ids in chunks of "
              f"{cfg.eval.knn_catalog_chunk_rows}, {rows[0]['queries']} queries): {out['knn_s']:.2f} s, recall "
              f"{out['recall']}; the catalog hashed in {hash_s:.2f} s and encoded at "
              f"{out['encode_ms_per_8192']:.3f} ms per 8192 ids ({cat_emb.nbytes / 2**20:.0f} MiB of f32 on the "
              f"host); the first query batch's top-{max_k}, chunked merge vs one (B, N) product and torch.topk on the "
              f"card: {id_miss} differing ids outside ties (of {int(untied.sum())}), scores max|diff| "
              f"{score_err:.3e}; the query batch {out['knn_query_launches']} flash_bias_fwd launches (expected "
              f"{layers}); its queries, kernel vs plain bias attention: max|err| {q_err:.3e} (tol {q_tol:.3e}), "
              f"mean|err| {q_mean:.3e} (tol {q_mean_tol:.3e})", flush=True)
        if id_miss or not untied.any() or score_err > TIE_EPS or q_err > q_tol or q_mean > q_mean_tol:
            raise AssertionError("the KNN eval's routes disagree")
        if out["knn_query_launches"] != layers:
            raise AssertionError("a KNN query batch did not run every layer through flash_bias_fwd")
        del cat_emb, v_1, idx_1

        # -- the batch inference: one row a real user, the direct call's bits
        table = pq.read_table(os.path.join(export_dir, "inference", "inference_results.parquet"))
        got = np.stack(table.column("user_encoder.user_emb").to_numpy(zero_copy_only=False))
        first = next(iter(get_host_dataloader("val", 0, get_val_data_paths(cfg.dataset),
                                              cfg.inference.inference_batch_size, None, strategy, feats,
                                              cfg.dataset.filesystem_config, drop_remainder=False)))
        before = fa.FLASH_BIAS_FWD.launches
        direct = wrapper.inference_models()["user_encoder"](program_inputs(first, "cuda"))["user_emb"].cpu().numpy()
        out["entry_launches"] = fa.FLASH_BIAS_FWD.launches - before
        same = table.num_rows == n_users and np.array_equal(got[: len(direct)], direct)
        rates, same_again = [], True
        for i in range(PIPE_INFER_PASSES):
            t1 = time.perf_counter()
            again = run_inference(wrapper, cfg, f"{tmp}/inference_again_{i}")
            torch.cuda.synchronize()
            rates.append(n_users / (time.perf_counter() - t1))
            same_again = same_again and pq.read_table(again).equals(table)
        out["inference_users_per_s"] = float(np.median(rates))
        print(f"[4] {smi}: the batch inference: {table.num_rows} rows ({n_users} users), columns "
              f"{table.column_names}; the first batch's user_emb {'bit-equal to' if same else 'DIFFERS from'} a "
              f"direct user_encoder call ({out['entry_launches']} flash_bias_fwd launches, expected {layers}); "
              f"{PIPE_INFER_PASSES} more runs {'write the same table' if same_again else 'DIFFER'}, "
              f"{out['inference_users_per_s']:.1f} users/s median of the runs (host clock, each over the "
              f"{n_users} users: {', '.join(f'{r:.1f}' for r in rates)})", flush=True)
        if not (same and same_again) or out["entry_launches"] != layers:
            raise AssertionError("the batch inference's vectors are not the model's, or not through the kernel")

        # -- the traced programs, in a fresh process
        trace = program_inputs(pipe._trace_batch, "cuda")
        torch.save(trace, f"{tmp}/trace.pt")
        root = os.path.dirname(os.path.abspath(__file__))
        t1 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", PROGRAM_SCRIPT, root, export_dir, f"{tmp}/trace.pt",
                               f"{tmp}/program_out.pt"], capture_output=True, text=True, timeout=600)
        sub_s = time.perf_counter() - t1
        if proc.returncode != 0:
            raise AssertionError(f"the .pt2 programs failed in a fresh process:\n{proc.stderr[-3000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        prog_out = torch.load(f"{tmp}/program_out.pt")
        allowed = {"recommendations_tpu_torch", "recommendations_tpu_torch.ops", "recommendations_tpu_torch.ops.cuda_build",
                   "recommendations_tpu_torch.ops.fused_attention", "recommendations_tpu_torch.core",
                   "recommendations_tpu_torch.core.debug", "recommendations_tpu_torch.core.spans"}
        eager_ms, bits = {}, {}
        for name in ("user_encoder", "sequence_encoder"):
            fn = wrapper.inference_models()[name]
            want_out = fn(trace)
            bits[name] = all(torch.equal(prog_out[name][k], want_out[k].cpu()) for k in want_out)
            ms = []
            for _ in range(10):
                t2 = time.perf_counter()
                fn(trace)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t2) * 1e3)
            eager_ms[name] = float(np.median(ms))
        names = list(wrapper.inference_models())
        if [len(export_calls[k]) for k in ("trace", "save")] != [len(names)] * 2:
            raise AssertionError(f"the export traced and saved {export_calls}, not once for each of {names}")
        secs = {f"{n}.{kind}_s": export_calls[kind][i] for i, n in enumerate(names) for kind in ("trace", "save")}
        out.update(export_seconds=secs, program_ms={n: res[f"{n}_ms"] for n in eager_ms}, eager_ms=eager_ms,
                   program_launches={n: res[f"{n}_launches"] for n in eager_ms})
        print(f"[4] {smi}: the traced export (trace batch of {len(next(iter(trace.values())))} users): trace/save "
              f"s {json.dumps({k: round(v, 2) for k, v in secs.items()})}; in a fresh process importing "
              f"{res['modules']} ({sub_s:.1f} s): flash_bias_fwd launches a call {out['program_launches']} (expected "
              f"{layers}), outputs {'bit-equal to' if all(bits.values()) else 'DIFFERENT from'} the eager wrapper "
              f"{bits}; a call {json.dumps({k: round(v, 3) for k, v in out['program_ms'].items()})} ms against the "
              f"eager request's {json.dumps({k: round(v, 3) for k, v in eager_ms.items()})} ms", flush=True)
        if (not all(bits.values()) or set(res["modules"]) - allowed
                or any(n != layers for n in out["program_launches"].values())):
            raise AssertionError("the exported programs do not reproduce the model through the bias kernel")
        del pipe, wrapper, state, trace, prog_out
        torch.cuda.empty_cache()

        # -- the compression job and the pretrained module
        rs = np.random.RandomState(3)
        vectors = rs.randn(PIPE_PRODUCTS, 128).astype(np.float32)
        values = pa.array(vectors.reshape(-1))
        offsets = pa.array(np.arange(0, vectors.size + 1, 128, dtype=np.int32))
        pq.write_table(pa.table({"product_id": [f"sku_{i}" for i in range(PIPE_PRODUCTS)],
                                 "emb_128": pa.ListArray.from_arrays(offsets, values)}), f"{tmp}/embs.parquet")
        k_shift = cfg.model.product_tower.latent_model_config.num_shifts_latent
        job = embedding_module_gen.execute(f"{tmp}/embs.parquet", f"{tmp}/artifact", dim=32, k_shift=k_shift,
                                           recon_epochs=PIPE_RECON_EPOCHS, mask_epochs=PIPE_MASK_EPOCHS,
                                           device="cuda")
        out["job"] = job
        rows_art = int(1.15 * PIPE_PRODUCTS)
        pcfg = load_config(main_training.CONFIG_ROOT / "lthm_train.yaml", overrides=parse_cli_overrides(
            [f"model.product_tower.model_init_metadata={{embedding_module_path: {tmp}/artifact}}",
             f"model.product_tower.latent_model_config.vocab_size_latent={rows_art}", "datestr=20240101"]),
            search_paths=[str(main_training.CONFIG_ROOT)])
        pw = LTHMModelWrapper(pcfg.model, device="cuda", seed=0)
        emb_mod = pw.module.product_emb_module
        art = embedding_module_gen.load_artifact(f"{tmp}/artifact")
        loaded = isinstance(emb_mod, PretrainedProductEmbedding) and all(
            np.array_equal(getattr(emb_mod, k).cpu().numpy(), v) for k, v in art.items())
        for kern in kernels:
            kern.launches = 0
        served = pw.inference_models()["user_encoder"](request_batch(900, BATCH, TRAINER_HISTORY))["user_emb"]
        serve_counts = fa.FLASH_BIAS_FWD.launches
        before = {k: v.clone() for k, v in emb_mod.named_buffers()}
        pstate = TrainState.create(pw, pcfg.train)
        loss, _ = train_step(pstate, request_batch(901, BATCH, TRAINER_HISTORY), offsets=[0, 5, 6, 12, 24, 30])
        kept = all(torch.equal(v, before[k]) and v.grad is None and not v.requires_grad
                   for k, v in emb_mod.named_buffers()) and not list(emb_mod.parameters())
        ok = (loaded and bool(torch.isfinite(served).all()) and serve_counts == layers
              and bool(torch.isfinite(loss)) and kept and fa.FLASH_BIAS_DKV.launches == layers)
        print(f"[4] {smi}: the compression job on {PIPE_PRODUCTS} 128-wide vectors (dim 32, {rows_art} rows, k "
              f"{k_shift}): reconstruction {job['reconstruction_s'] / PIPE_RECON_EPOCHS:.3f} s an epoch "
              f"({PIPE_RECON_EPOCHS}), mask model {job['mask_s'] / PIPE_MASK_EPOCHS:.3f} s an epoch "
              f"({PIPE_MASK_EPOCHS}), read {job['read_s']:.2f} s; lthm_train.yaml on its artifact: the buffers "
              f"{'hold the artifact' if loaded else 'DO NOT hold the artifact'}, a request of {BATCH} users "
              f"({serve_counts} bias forwards) and a training step (loss {loss.item():.5f}), the buffers "
              f"{'untouched and without a gradient' if kept else 'CHANGED or took a gradient'}", flush=True)
        if not ok:
            raise AssertionError("the pretrained module did not serve and train as a frozen module")
        del pw, pstate, emb_mod, before
        torch.cuda.empty_cache()

        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        FakeDataStore.reset()


def cfg_batch(pipeline) -> int:
    return pipeline.pipeline_config.train.batch_size


def cfg_val_batches(pipeline) -> int:
    """The batches of one validation (the eval cache: the first
    ``validation_steps`` batches of the validation files)."""
    return pipeline.pipeline_config.train.validation_steps


def bias_sweep(fa):
    """Phase [5]: one attention layer (d=512, MQA 32x16, bf16, position bias
    at window T, causal) forward + backward at T = window, on the fused bias
    kernels and on _sdpa with the bias, at B = 16 and 64; the measurement
    behind taking the bias kernels at every T == window on the card."""
    from recommendations_tpu_torch.nn.attention import MultiQueryAttention

    dt, out = torch.bfloat16, {}
    for b in (16, 64):
        for tl in SWEEP_WINDOWS:
            x = torch.randn(b, tl, 512, device="cuda").to(dt).requires_grad_()
            dy = torch.randn(b, tl, 512, device="cuda").to(dt)
            for fused in (True, False):
                layer = MultiQueryAttention(512, 32, torch.Generator(device="cuda").manual_seed(3), use_bias=False,
                                            pos_bias_window=tl, use_flash=fused, dtype=dt)

                def fwd_bwd():
                    layer(x, causal=True).backward(dy)

                before = fa.FLASH_BIAS_FWD.launches
                fwd_bwd()
                if (fa.FLASH_BIAS_FWD.launches > before) != fused:
                    raise AssertionError("the layer did not take the path it was timed for")
                out[(b, tl, fused)] = cuda_ms(fwd_bwd, 5)
                del layer
            del x, dy
            torch.cuda.empty_cache()
            print(f"[5] one attention layer at T = window = {tl}, B={b} (d=512, MQA 32x16, bf16) forward + "
                  f"backward: fused bias kernels {out[(b, tl, True)]:.4f} ms, _sdpa with the bias "
                  f"{out[(b, tl, False)]:.4f} ms", flush=True)
    return out


# -- 6. the multi-device layers on one card ------------------------------------------------

DP_WORLD = 2  # ranks of phase [6], on the one card, joined by a gloo group
DP_USERS = 32  # users a rank in (a): 2 x 32 = 64 global
DP_STEPS = 3
TABLE_USERS = 64  # (b)'s ids: 64 users of 512 events
RING_BATCH = 8  # (c)
EP_USERS = 16  # (d)
RANKER_DP_STEPS = 4  # (f): steps of ranker_train.yaml's batch over the data axis
RANKER_DP_PAD = 37  # (f): pad rows at the global batch's end, all on the last rank
RANKER_DP_LOSS_TOL = 1e-5  # tests/test_torch_ranker_mesh.py's: the loss and the metrics
RANKER_DP_PARAM_TOL = 2e-4  # and the parameters after the steps, norm-relative
PHASE6_TIMEOUT_S = 420


def _phase6_dp(kernels):
    """(a): the production LTHM at lthm.yaml's context 512 (fused CE, frozen
    table) over a data axis of DP_WORLD ranks, DP_USERS users each: step 1's
    loss and summed gradients held to one process's step on the 64 users
    (same weights), a warm-up and DP_STEPS timed steps with the launch
    counts and the reduction's time, and a digest of the parameters after
    them."""
    import hashlib

    from recommendations_tpu_torch.core.mesh import MeshConfig, build_mesh
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.train import step as step_mod
    from recommendations_tpu_torch.train.train_state import TrainState

    cfg = LTHMModelConfig.from_dict(production_config(CTX512))
    mesh = build_mesh(MeshConfig(data=DP_WORLD), device="cuda")
    batch = request_batch(600, DP_WORLD * DP_USERS, CTX512 + 8)
    start = mesh.index("data") * DP_USERS
    local = {k: v[start:start + DP_USERS] for k, v in batch.items()}
    offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
    one = LTHMModelWrapper(cfg, device="cuda", seed=0)
    random_bias_tables(one, 7)
    one_loss, one_grads = grads_of(one, batch, one.init_aux_state(), offsets)
    del one
    torch.cuda.empty_cache()
    wrapper = LTHMModelWrapper(cfg, device="cuda", seed=0)
    random_bias_tables(wrapper, 7)
    wrapper.bind_mesh(mesh)
    loss, metrics, _ = wrapper.loss_and_metrics(local, wrapper.init_aux_state(), True, offsets=offsets)
    loss.backward()
    step_mod.reduce_gradients(wrapper)
    grads = {n: p.grad for n, p in wrapper.module.named_parameters() if p.grad is not None}
    if set(grads) != set(one_grads):
        raise AssertionError("(a): the two steps gave gradients for different parameters")
    worst = max((rel_err(grads[n], one_grads[n]), n) for n in grads)
    dp_loss = metrics["train_loss"].item()
    wrapper.module.zero_grad(set_to_none=True)
    del one_grads, grads
    state = TrainState.create(wrapper, seed=1)
    real_reduce, reduce_ms = step_mod.reduce_gradients, []

    def timed_reduce(w):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(w)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    step_mod.reduce_gradients = timed_reduce
    try:
        step_mod.train_step(state, local, offsets=offsets)  # warm-up
        torch.cuda.synchronize()
        reduce_ms.clear()
        for kern in kernels:
            kern.launches = 0
        step_ms, losses = [], []
        for _ in range(DP_STEPS):
            t0 = time.perf_counter()
            loss_t, _ = step_mod.train_step(state, local, offsets=offsets)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss_t.item())
        counts = {kern.name: kern.launches for kern in kernels}
    finally:
        step_mod.reduce_gradients = real_reduce
    digest = hashlib.sha256()
    for name, p in sorted(wrapper.module.named_parameters()):
        digest.update(name.encode() + p.detach().cpu().numpy().tobytes())
    out = {"loss": dp_loss, "one_loss": one_loss, "worst": worst, "step_ms": step_ms, "reduce_ms": reduce_ms,
           "losses": losses, "counts": counts, "digest": digest.hexdigest(),
           "layers": cfg.transformer_config.num_layers, "heads": len(cfg.lookahead)}
    del state, wrapper
    torch.cuda.empty_cache()
    return out


def _phase6_table():
    """(b): lthm.yaml's 10M-row table (d = 32, 8 shifts, normalized) at
    model = DP_WORLD (5M rows a rank): both schedules' forward and table
    gradient held to the dense lookup on float32 rows (the JAX tests'
    arithmetic), and the overflow count at a capacity factor of 0.05."""
    from recommendations_tpu_torch.core.mesh import MeshConfig, build_mesh
    from recommendations_tpu_torch.nn.embeddings import KShiftEmbedding
    from recommendations_tpu_torch.parallel.sharded_embedding import ShardedKShiftEmbedding

    tc = production_config(CTX512)["product_tower"]
    rows, dim = tc["latent_model_config"]["vocab_size_latent"], tc["inp_emb_dim"]
    shifts = tc["latent_model_config"]["num_shifts_latent"]
    mesh = build_mesh(MeshConfig(data=1, model=DP_WORLD), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    dense = KShiftEmbedding(rows, dim, gen, num_shifts=shifts, normalize_output=True)
    per = rows // mesh.size("model")
    lo = mesh.index("model") * per
    ids = torch.from_numpy(request_batch(700, TABLE_USERS, CTX512)["product_ids"]).cuda()
    target = torch.randn((*ids.shape, dim), generator=gen, device="cuda")
    want = dense(ids)
    ((want - target) ** 2).sum().backward()
    want_grad = dense.embedding.grad[lo:lo + per]
    out = {"rows": rows, "rows_per_rank": per, "dim": dim, "tokens": ids.numel()}
    for schedule, cf in (("psum", 2.0), ("alltoall", 2.0), ("alltoall_low", 0.05)):
        emb = ShardedKShiftEmbedding(dense.embedding.detach()[lo:lo + per].clone(), rows, mesh, num_shifts=shifts,
                                     normalize_output=True, schedule=schedule.split("_")[0], capacity_factor=cf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = emb(ids)
        ((got - target) ** 2).sum().backward()
        torch.cuda.synchronize()
        out[schedule] = {
            "ms": (time.perf_counter() - t0) * 1e3,
            "fwd_err": (got - want).abs().max().item(),
            "grad_err": (emb.embedding.grad - want_grad).abs().max().item(),
            "grad_max": want_grad.abs().max().item(),
            "overflow": None if emb.overflow is None else emb.overflow.item(),
            "zero_rows": int((got.detach().abs().sum(-1) == 0).sum().item()),
        }
        del emb
    del dense, want_grad
    torch.cuda.empty_cache()
    return out


def _phase6_ring(fa):
    """(c): ring attention over DP_WORLD ranks at lthm.yaml's widths (MQA
    32x16, the bias window = T) at T = 513 and T = 1025 (both padded to the
    ring), outputs and gradients (the table's included) held to the one-rank
    bias kernels (flash_bias_fwd, flash_bias_dq, flash_bias_dkv) on the same
    bf16 inputs and a bf16-valued table. Tolerance: the kernels round p and
    dS to bf16 before their products, the ring keeps them in float32, so
    each output may move by 2**-8 of its terms' sum: norm-relative 2**-7."""
    from recommendations_tpu_torch.core.mesh import MeshConfig, build_mesh
    from recommendations_tpu_torch.parallel.ring_attention import ring_attention_padded

    mesh = build_mesh(MeshConfig(data=1, model=DP_WORLD), device="cuda")
    heads, hd, out = 32, 16, {}
    for t in (CTX512 + 1, PROD_CONTEXT + 1):
        g = torch.Generator(device="cuda").manual_seed(t)
        q, k, v = randn_qkv(RING_BATCH, t, heads, hd, 1, torch.bfloat16, seed=t)
        table = torch.randn(2 * t + 1, heads, generator=g, device="cuda").bfloat16().float()
        do = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
        ins = [x.detach().clone().requires_grad_() for x in (q, k, v, table)]
        ref = fa.fused_flash_attention_bias(*ins, heads, t, True)
        ref.backward(do)
        rin = [x.detach().clone().requires_grad_() for x in (q, k, v, table)]
        qh = rin[0].reshape(RING_BATCH, t, heads, hd).transpose(1, 2)
        kh, vh = (x.reshape(RING_BATCH, t, 1, hd).transpose(1, 2) for x in rin[1:3])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ring_attention_padded(qh, kh, vh, mesh.group("model"), causal=True, bias_table=rin[3], nk=t)
        got = got.transpose(1, 2).reshape(RING_BATCH, t, heads * hd)
        got.backward(do)
        torch.cuda.synchronize()
        errs = {"o": rel_err(got.detach(), ref.detach())}
        errs.update({n: rel_err(a.grad, b.grad) for n, a, b in zip(("dq", "dk", "dv", "dtable"), rin, ins)})
        out[t] = {"errs": errs, "ms": (time.perf_counter() - t0) * 1e3,
                  "finite": all(bool(torch.isfinite(x.grad).all()) for x in rin)}
    torch.cuda.empty_cache()
    return out


def _phase6_experts():
    """(d): the MoE LTHM of phases [3]/[4] (4 experts, top-2) at expert =
    DP_WORLD: the loss and every gradient of one training forward on
    EP_USERS users held to one process's (this rank's block of the expert
    stacks), with every expert mixed (top-k off) and with the top-2
    routing, as phase [4] holds the MoE path to plain attention: the split
    sums the float32 mix in another order, so a bf16 rounding may flip and
    travel through the layers (2**-5, four ulps); with routing, a token
    whose 2nd and 3rd gates lie within an ulp may take another expert pair
    (2**-2)."""
    from recommendations_tpu_torch.nn.transformer import MoELinear
    from recommendations_tpu_torch.core.mesh import MeshConfig, build_mesh
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper

    cfg = LTHMModelConfig.from_dict(moe_config())
    mesh = build_mesh(MeshConfig(data=1, expert=DP_WORLD), device="cuda")
    batch = request_batch(800, EP_USERS, CTX512 + 8)
    offsets = sample_offsets(torch.Generator().manual_seed(6), cfg.lookahead)
    one = LTHMModelWrapper(cfg, device="cuda", seed=0)
    ep = LTHMModelWrapper(cfg, device="cuda", seed=0)
    for w in (one, ep):
        random_bias_tables(w, 7)
    ep.bind_mesh(mesh)
    experts, n = ep.sharded_params(), mesh.size("expert")
    out = {"sharded": len(experts), "stack_shape": list(ep.module.query_tower.transformer.block_0.moe_fc.w1.shape)}
    for label, top_k in (("mixed", None), ("routed", cfg.transformer_config.rotator().top_k)):
        for w in (one, ep):
            for m in w.module.modules():
                if isinstance(m, MoELinear):
                    m.top_k = top_k
        one_loss, one_grads = grads_of(one, batch, one.init_aux_state(), offsets)
        loss, grads = grads_of(ep, batch, ep.init_aux_state(), offsets)
        for name in experts:
            per = one_grads[name].shape[0] // n
            one_grads[name] = one_grads[name][mesh.index("expert") * per:(mesh.index("expert") + 1) * per]
        out[label] = {"loss": loss, "one_loss": one_loss,
                      "worst": max((rel_err(grads[k], one_grads[k]), k) for k in one_grads)}
        del grads, one_grads
    del one, ep
    torch.cuda.empty_cache()
    return out


def _ranker_dp_inputs():
    """(f)'s config (ranker_train.yaml at ranker.yaml's widths) and global
    batch (the YAML's batch size, the last RANKER_DP_PAD rows padding)."""
    from recommendations_tpu_torch import main_training

    cfg = main_training.load_config(main_training.CONFIG_ROOT / "ranker_train.yaml",
                                    search_paths=[str(main_training.CONFIG_ROOT)])
    n = cfg.train.batch_size
    batch = ranker_batch(cfg.model, 900, n)
    batch["_pad_mask"] = np.arange(n) >= n - RANKER_DP_PAD
    return cfg, batch


def _ranker_dp_steps(cfg, wrapper, batch, kernels):
    """RANKER_DP_STEPS train steps of ``wrapper`` on ``batch`` (a rank's rows
    on a mesh): each step's loss and host time (synchronized), the
    gradient all-reduce's times, the launch counts, the parameters after."""
    from recommendations_tpu_torch.train import step as step_mod
    from recommendations_tpu_torch.train.train_state import TrainState

    state = TrainState.create(wrapper, cfg.train)
    real_reduce, reduce_ms = step_mod.reduce_gradients, []

    def timed_reduce(w):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(w)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    for kern in kernels:
        kern.launches = 0
    step_mod.reduce_gradients = timed_reduce
    losses, step_ms = [], []
    try:
        for _ in range(RANKER_DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, metrics = step_mod.train_step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
    finally:
        step_mod.reduce_gradients = real_reduce
    params = {n: p.detach().clone() for n, p in wrapper.module.named_parameters()}
    return {"losses": losses, "step_ms": step_ms, "reduce_ms": reduce_ms, "params": params,
            "metrics": {k: v.item() for k, v in metrics.items()},
            "counts": {kern.name: kern.launches for kern in kernels}}


def _phase6_ranker(kernels):
    """(f): the ranker of ranker_train.yaml over a data axis of DP_WORLD
    ranks, each its rows of the global batch (the pad rows all on the last
    rank), against one process on the whole batch from the same weights:
    each step's loss and the parameters after RANKER_DP_STEPS steps, the
    launch counts (the ranker launches none), a rank's step time and the
    all-reduce's share."""
    import hashlib

    from recommendations_tpu_torch.core.mesh import MeshConfig, build_mesh
    from recommendations_tpu_torch.models.ranker.wrapper import RankerModelWrapper

    cfg, batch = _ranker_dp_inputs()
    one = _ranker_dp_steps(cfg, RankerModelWrapper(cfg.model, device="cuda", seed=0), batch, kernels)
    mesh = build_mesh(MeshConfig(data=DP_WORLD), device="cuda")
    per = cfg.train.batch_size // DP_WORLD
    start = mesh.index("data") * per
    wrapper = RankerModelWrapper(cfg.model, device="cuda", seed=0)
    wrapper.bind_mesh(mesh)
    dp = _ranker_dp_steps(cfg, wrapper, {k: v[start:start + per] for k, v in batch.items()}, kernels)
    digest = hashlib.sha256()
    for name, p in sorted(dp["params"].items()):
        digest.update(name.encode() + p.cpu().numpy().tobytes())
    worst = max((rel_err(dp["params"][n], one["params"][n]), n) for n in one["params"])
    out = {k: dp[k] for k in ("losses", "step_ms", "reduce_ms", "counts", "metrics")}
    out.update(one_losses=one["losses"], one_metrics=one["metrics"], worst=worst, digest=digest.hexdigest(),
               rows=per, pad=int(batch["_pad_mask"][start:start + per].sum()), batch=cfg.train.batch_size,
               n_params=sum(p.numel() for p in dp["params"].values()))
    del wrapper, one, dp
    torch.cuda.empty_cache()
    return out


def phase6_rank(argv) -> int:
    """A rank of phase [6] (``python chip_smoke.py --phase6-rank RANK WORLD
    PORT OUT``): joins the gloo group on the one card, runs (a)-(d) and (f)
    and writes its results to OUT/rank<RANK>.json."""
    import torch.distributed as dist

    from recommendations_tpu_torch.core.mesh import init_distributed
    from recommendations_tpu_torch.ops import fused_attention as fa
    from recommendations_tpu_torch.ops import fused_ce as fc

    rank, world, port, out_dir = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    init_distributed("cuda", backend="gloo", init_method=f"tcp://127.0.0.1:{port}", world=world, rank=rank)
    kernels = (*fa.KERNELS, *fc.KERNELS)
    for kern in kernels:
        kern.build()  # the parent's builds, found by their hash
    t0 = time.perf_counter()
    res = {"backend": dist.get_backend()}
    res["dp"] = _phase6_dp(kernels)
    res["table"] = _phase6_table()
    res["ring"] = _phase6_ring(fa)
    res["experts"] = _phase6_experts()
    res["ranker"] = _phase6_ranker(kernels)
    res["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _phase6_nccl(kernels):
    """(e): (a)'s step through a one-rank NCCL group in this process: every
    collective of the data-parallel step (the loss's gathers and metric
    reductions, the gradient all-reduce, the NaN flag) runs on NCCL on the
    card, moving no data; then (f)'s ranker steps the same way, against one
    process without a mesh."""
    import datetime

    import torch.distributed as dist

    from recommendations_tpu_torch.core.mesh import Mesh
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60), device_id=torch.device("cuda", 0))
    try:
        cfg = LTHMModelConfig.from_dict(production_config(CTX512))
        wrapper = LTHMModelWrapper(cfg, device="cuda", seed=0)
        random_bias_tables(wrapper, 7)
        wrapper.bind_mesh(Mesh.one_rank(dist.group.WORLD, "cuda"))
        state = TrainState.create(wrapper, seed=1)
        batch = request_batch(610, DP_USERS, CTX512 + 8)
        offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
        train_step(state, batch, offsets=offsets)  # warm-up
        torch.cuda.synchronize()
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        loss, metrics = train_step(state, batch, offsets=offsets)
        torch.cuda.synchronize()
        out = {"backend": dist.get_backend(), "ms": (time.perf_counter() - t0) * 1e3, "loss": loss.item(),
               "grad_norm": metrics["grad_norm"].item(), "params_nan": metrics["params_nan"].item(),
               "counts": {kern.name: kern.launches for kern in kernels}}
        del state, wrapper
        torch.cuda.empty_cache()
        # (f)'s ranker step on the whole batch through the same group, against one process
        from recommendations_tpu_torch.models.ranker.wrapper import RankerModelWrapper

        rcfg, rbatch = _ranker_dp_inputs()
        one = _ranker_dp_steps(rcfg, RankerModelWrapper(rcfg.model, device="cuda", seed=0), rbatch, kernels)
        ranker = RankerModelWrapper(rcfg.model, device="cuda", seed=0)
        ranker.bind_mesh(Mesh.one_rank(dist.group.WORLD, "cuda"))
        got = _ranker_dp_steps(rcfg, ranker, rbatch, kernels)
        out["ranker"] = {"losses": got["losses"], "one_losses": one["losses"], "step_ms": got["step_ms"],
                         "reduce_ms": got["reduce_ms"], "counts": got["counts"],
                         "worst": max(rel_err(got["params"][n], one["params"][n]) for n in one["params"])}
        del one, got, ranker
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def distributed_phase(kernels, smi):
    """Phase [6]: DP_WORLD processes on the one card joined by a gloo group
    (NCCL refuses two ranks on one GPU) run (a)-(d) at full width, then (e)
    runs (a)'s step here through a one-rank NCCL group. Neither measures
    NCCL across cards: the gloo group moves every tensor through the host.
    Returns the numbers for the kernels line."""
    import subprocess
    import tempfile

    t0 = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_phase6_")
    port = _free_port()
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w") for r in range(DP_WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase6-rank", str(r), str(DP_WORLD),
                               str(port), out_dir], stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(DP_WORLD)]
    try:
        for r, p in enumerate(procs):
            left = PHASE6_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                rc = p.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                logs[r].flush()
                with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                    print(f.read()[-6000:], flush=True)
                raise AssertionError(f"[6] rank {r} {'hung' if rc is None else f'exited {rc}'}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    ok = all(res["backend"] == "gloo" for res in ranks)

    # (a) data-parallel training
    dp = [res["dp"] for res in ranks]
    layers, heads = dp[0]["layers"], dp[0]["heads"]
    want = {k.name: 0 for k in kernels}
    want.update({n: layers for n in ("flash_bias_fwd", "flash_bias_dq", "flash_bias_dkv")})
    want.update({k: heads for k in ("ce_row_diag", "ce_fwd", "ce_dq", "ce_dc")})  # one 32-user chunk a head
    per_step = [{k: n // DP_STEPS for k, n in d["counts"].items()} for d in dp]
    counts_ok = all(ps == want for ps in per_step)
    same_bits = len({d["digest"] for d in dp}) == 1 and len({tuple(d["losses"]) for d in dp}) == 1
    grad_ok = all(d["worst"][0] <= 2**-6 and abs(d["loss"] - d["one_loss"]) <= 1e-3 * abs(d["one_loss"]) for d in dp)
    finite = all(math.isfinite(x) for d in dp for x in d["losses"])
    step_ms = [x for d in dp for x in d["step_ms"]]
    share = sum(sum(d["reduce_ms"]) for d in dp) / sum(step_ms)
    print(f"[6] {smi}: {DP_WORLD} ranks on one card, backends {[res['backend'] for res in ranks]} (gloo through "
          f"the host, not NCCL)", flush=True)
    print(f"[6] (a) data-parallel lthm.yaml (context 512, fused CE, frozen table), {DP_WORLD} x {DP_USERS} users: "
          f"step 1 loss {dp[0]['loss']:.6f} vs one process on {DP_WORLD * DP_USERS} users {dp[0]['one_loss']:.6f}, "
          f"worst gradient {dp[0]['worst'][1]} at norm-relative {max(d['worst'][0] for d in dp):.3e} (tol 2**-6: "
          f"bf16 products over 32 rows against 64 may round apart, the ranks' parts summed in another order); "
          f"launches a rank and step {per_step[0]} (want {want}); losses {dp[0]['losses']}; parameters the same "
          f"bits on every rank {same_bits} -> {'ok' if counts_ok and same_bits and grad_ok and finite else 'FAIL'}",
          flush=True)
    print(f"[6] (a) {smi}: step {[round(x, 3) for x in step_ms]} ms, gradient all-reduce "
          f"{[round(x, 3) for d in dp for x in d['reduce_ms']]} ms, its share {100 * share:.1f}% (gloo through the "
          f"host, not NCCL)", flush=True)
    ok &= counts_ok and same_bits and grad_ok and finite

    # (b) the row-sharded table
    for r, res in enumerate(ranks):
        tb = res["table"]
        b_ok = all(tb[s]["fwd_err"] <= 2e-5 and tb[s]["grad_err"] <= 2e-4 * max(1.0, tb[s]["grad_max"])
                   and tb[s]["overflow"] in (None, 0.0) and tb[s]["zero_rows"] == 0 for s in ("psum", "alltoall"))
        b_ok &= tb["alltoall_low"]["overflow"] > 0 and tb["alltoall_low"]["zero_rows"] > 0
        print(f"[6] (b) rank {r}: the {tb['rows']}-row table at model = {DP_WORLD} ({tb['rows_per_rank']} rows a "
              f"rank, d = {tb['dim']}, {tb['tokens']} tokens): " + "; ".join(
                  f"{s} forward {tb[s]['fwd_err']:.2e} (tol 2e-5), table gradient {tb[s]['grad_err']:.2e} (tol 2e-4 "
                  f"x max(1, {tb[s]['grad_max']:.2e})), {tb[s]['ms']:.1f} ms" for s in ("psum", "alltoall"))
              + f"; capacity factor 0.05: overflow {tb['alltoall_low']['overflow']:.0f} requests, "
              f"{tb['alltoall_low']['zero_rows']} tokens read zero rows -> {'ok' if b_ok else 'FAIL'}", flush=True)
        ok &= b_ok

    # (c) ring attention
    for r, res in enumerate(ranks):
        for t, rg in res["ring"].items():
            c_ok = rg["finite"] and all(e <= 2**-7 for e in rg["errs"].values())
            print(f"[6] (c) rank {r}: ring attention over {DP_WORLD} ranks, B={RING_BATCH} T={t} MQA 32x16, the bias "
                  f"window {t}: norm-relative " + ", ".join(f"{n} {e:.2e}" for n, e in rg["errs"].items())
                  + f" against flash_bias_fwd/dq/dkv (tol 2**-7: the kernels round p and dS to bf16); "
                  f"{rg['ms']:.1f} ms -> {'ok' if c_ok else 'FAIL'}", flush=True)
            ok &= c_ok

    # (d) expert parallelism
    for r, res in enumerate(ranks):
        ex = res["experts"]
        d_ok = ex["stack_shape"][0] == 4 // DP_WORLD and ex["sharded"] > 0
        for label, tol in (("mixed", 2**-5), ("routed", 2**-2)):
            e = ex[label]
            d_ok &= e["worst"][0] <= tol and abs(e["loss"] - e["one_loss"]) <= 2**-8 * abs(e["one_loss"])
        print(f"[6] (d) rank {r}: the MoE LTHM at expert = {DP_WORLD} ({ex['sharded']} expert stacks split, "
              f"w1 {ex['stack_shape']}), {EP_USERS} users, against one process: " + "; ".join(
                  f"{text} loss {ex[key]['loss']:.6f} vs {ex[key]['one_loss']:.6f}, worst gradient "
                  f"{ex[key]['worst'][1]} at norm-relative {ex[key]['worst'][0]:.3e} (tol {tol_s})"
                  for key, text, tol_s in (("mixed", "every expert mixed", "2**-5"),
                                           ("routed", "top-2 routed", "2**-2")))
              + f" -> {'ok' if d_ok else 'FAIL'}", flush=True)
        ok &= d_ok

    # (f) the ranker over the mesh
    rk = [res["ranker"] for res in ranks]
    r0 = rk[0]
    f_loss = max(abs(a - b) for a, b in zip(r0["losses"], r0["one_losses"]))
    f_metrics = max(abs(r0["metrics"][k] - r0["one_metrics"][k]) for k in r0["one_metrics"]
                    if k not in ("grad_norm", "params_nan"))
    f_ok = (f_loss <= RANKER_DP_LOSS_TOL and f_metrics <= RANKER_DP_LOSS_TOL
            and all(d["worst"][0] <= RANKER_DP_PARAM_TOL for d in rk) and len({d["digest"] for d in rk}) == 1
            and all(not any(d["counts"].values()) for d in rk)
            and all(math.isfinite(x) for d in rk for x in d["losses"]))
    f_step = [x for d in rk for x in d["step_ms"][1:]]  # each rank's first step warms up
    f_share = sum(sum(d["reduce_ms"][1:]) for d in rk) / sum(f_step)
    print(f"[6] (f) the ranker of ranker_train.yaml ({r0['n_params']} parameters) over data = {DP_WORLD}, "
          f"{r0['rows']} of the batch's {r0['batch']} rows a rank ({[d['pad'] for d in rk]} of them padding): "
          f"losses {[round(x, 6) for x in r0['losses']]} vs one process {[round(x, 6) for x in r0['one_losses']]} "
          f"(worst {f_loss:.2e}, the last step's metrics {f_metrics:.2e}, tol {RANKER_DP_LOSS_TOL}), parameters "
          f"after {RANKER_DP_STEPS} steps: worst {r0['worst'][1]} at norm-relative "
          f"{max(d['worst'][0] for d in rk):.2e} (tol {RANKER_DP_PARAM_TOL}), the same bits on every rank "
          f"{len({d['digest'] for d in rk}) == 1}, launches {r0['counts']} (the ranker's products are plain "
          f"matmuls) -> {'ok' if f_ok else 'FAIL'}", flush=True)
    print(f"[6] (f) {smi}: a rank's step {[round(x, 3) for x in f_step]} ms (after one warm-up step), gradient "
          f"all-reduce {[round(x, 3) for d in rk for x in d['reduce_ms'][1:]]} ms, its share "
          f"{100 * f_share:.1f}% (gloo through the host, not NCCL)", flush=True)
    ok &= f_ok

    # (e) the NCCL path, one rank
    nc = _phase6_nccl(kernels)
    e_ok = (nc["backend"] == "nccl" and nc["counts"] == want and math.isfinite(nc["loss"])
            and nc["params_nan"] == 0.0)
    print(f"[6] (e) {smi}: (a)'s step through a one-rank {nc['backend']} group ({DP_USERS} users; its collectives "
          f"move no data): loss {nc['loss']:.6f}, grad norm {nc['grad_norm']:.4f}, launches {nc['counts']}, "
          f"{nc['ms']:.3f} ms -> {'ok' if e_ok else 'FAIL'}", flush=True)
    ok &= e_ok
    nr = nc["ranker"]
    e_ranker = max(abs(a - b) for a, b in zip(nr["losses"], nr["one_losses"]))
    ef_ok = (e_ranker <= RANKER_DP_LOSS_TOL and nr["worst"] <= RANKER_DP_PARAM_TOL and not any(nr["counts"].values()))
    print(f"[6] (e) {smi}: (f)'s ranker through the one-rank {nc['backend']} group on the whole batch: losses "
          f"{[round(x, 6) for x in nr['losses']]} vs one process without a mesh (worst {e_ranker:.2e}, tol "
          f"{RANKER_DP_LOSS_TOL}), parameters at norm-relative {nr['worst']:.2e} (tol {RANKER_DP_PARAM_TOL}), "
          f"launches {nr['counts']}; step {[round(x, 3) for x in nr['step_ms'][1:]]} ms, all-reduce "
          f"{[round(x, 3) for x in nr['reduce_ms'][1:]]} ms -> {'ok' if ef_ok else 'FAIL'}", flush=True)
    ok &= ef_ok
    seconds = time.perf_counter() - t0
    print(f"[6] the phase took {seconds:.1f} s (ranks' own work {max(res['seconds'] for res in ranks):.1f} s)",
          flush=True)
    if not ok:
        raise AssertionError("[6] the multi-device phase failed")
    return {"per_rank_step": per_step[0], "step_ms": step_ms, "reduce_share": share, "seconds": seconds,
            "ranker_step_ms": f_step, "ranker_reduce_share": f_share, "ranker_nccl_step_ms": nr["step_ms"][1:]}


# -- phase [7]: the recorded runs at full length ---------------------------------
QUALITY_SEEDS = (0, 1, 2)  # seed s: the port's initial weights from torch seed s, the data from seed 100 s
QUALITY_DATES = ["20240101", "20240102"]  # train on the first, validate on the second
LTHM_TINY_STEPS, LTHM_TINY_EPOCHS = 600, 20  # QUALITY.md's config 1
LTHM_TINY_FILES, LTHM_TINY_USERS, LTHM_TINY_HISTORY = 2, 800, 64
# the kernels' shapes on the kernel arm (configs/lthm_tiny.yaml: batch 32, context 48 and the CLS column, MQA
# 4 heads of 16, bf16; one CE call a lookahead head over the whole batch: N = 32 x 48, D = the heads'
# product_emb_dim 32)
LTHM_TINY_FLASH = (32, 49, 4, 16, 1, torch.bfloat16, True)
LTHM_TINY_CE = (32 * 48, 48, 32, 0.0, "roll")
LTHM_TINY_KERNEL_ARGS = ("model.transformer_config.use_flash_attention=true", "model.fused_ce=true")
RANKER_QUALITY_STEPS = 400  # QUALITY.md's "400 steps x 10 epochs": the YAML's 10 epochs end the run at 320
# The JAX package's figures on the CPU, the same configs, data and seeds (seed s: PRNGKey(s), data seed 100 s):
# tools/quality_reference.py, mean and sample standard deviation (ddof 1) over seeds 0-2.
JAX_LTHM_TINY = {
    "val_hit_rate_at_1_lookahead_0": (0.21157394846280417, 0.013953419760621633),
    "val_hit_rate_at_5_lookahead_0": (0.38086913526058197, 0.020845805414145584),
    "val_hit_rate_at_20_lookahead_0": (0.5722941209872564, 0.021022301419160176),
    "val_median_hit_position_lookahead_0": (11.916666666666666, 1.9094065395649333),
    "val_loss": (18.09446907043457, 0.10645487337101217),
}
JAX_RANKER = {
    "val_auc_click": (0.674214780330658, 0.013090268865719077),
    "val_auc_conversion": (0.7400488456090292, 0.04296940372903223),
    "val_loss": (0.6599675019582113, 0.02042106561867835),
}
# joint_train uncut (synth.seed = 100 s): the held-out-user AUC with the embeddings and the uplift over the
# ablated arm. The port runs seed 0 (the config's own) only: one uncut run takes most of the phase.
JAX_JOINT = {
    "val_auc_click_with_embeddings": (0.6945308413770465, 0.013404353332213511),
    "auc_uplift_click": (0.08736265947421391, 0.021447882248827738),
}
JOINT_UPLIFT_RANGE = (0.08, 0.12)  # QUALITY.md's +0.1008 (a TPU v5e) and the harness's +0.095, +-0.02


def band_floor(metric: str) -> float:
    """The least half-width of a band: 0.02 for a hit rate or an AUC, 2
    positions for the median hit position, 0.2 for a loss."""
    if "median_hit_position" in metric:
        return 2.0
    if metric.endswith("loss"):
        return 0.2
    return 0.02


def quality_band(metric: str, std: float) -> float:
    """The wider of twice JAX's seed spread and the metric's floor."""
    return max(2.0 * std, band_floor(metric))


def held_in_band(label: str, got: dict, ref: dict) -> list:
    """One line a metric: the mean over seeds beside the reference (mean,
    spread) and its band, ``-> ok`` or ``-> MISS``; returns the misses."""
    misses = []
    for metric, (mean, std) in ref.items():
        vals = got[metric]
        value = float(np.mean(vals))
        width = quality_band(metric, std)
        ok = abs(value - mean) <= width
        print(f"[7] {label} {metric}: {value:.4f} (seeds {[round(v, 4) for v in vals]}) against {mean:.4f} "
              f"(spread {std:.4f}), band +-{width:.4f} -> {'ok' if ok else 'MISS'}", flush=True)
        if not ok:
            misses.append(f"{label} {metric}")
    return misses


@contextlib.contextmanager
def seeded_builder(builder_cls, seed: int):
    """The builder's weights drawn from ``seed`` for the length of the block
    (main_training's builders draw them from seed 0)."""
    real = builder_cls.build

    def build(builder):
        builder.seed = seed
        return real(builder)

    builder_cls.build = build
    try:
        yield
    finally:
        builder_cls.build = real


def quality_lthm_tiny(kernels, smi, tmp):
    """(a): main_training --config-name lthm_tiny for 600 steps at every seed,
    the plain arm (the YAML as it stands: plain attention and the eager CE,
    whose every step launches the four CE kernels' rounded case and every
    validation batch ce_row_diag_rounded and ce_fwd_rounded) and the kernel
    arm (flash attention and the fused CE: every step launches flash_fwd,
    flash_bwd and the four CE kernels, every validation batch flash_fwd,
    ce_row_diag and ce_fwd), on the port's synth click log in the in-memory
    store."""
    from recommendations_tpu_torch import main_training
    from recommendations_tpu_torch.data.data_store import FakeDataStore
    from recommendations_tpu_torch.models.lthm.builder import LTHMModelBuilder
    from recommendations_tpu_torch.ops import fused_ce as fc
    from recommendations_tpu_torch.tools.synth_data import write_synthetic_dataset

    arms = {"plain": {m: [] for m in JAX_LTHM_TINY}, "kernels": {m: [] for m in JAX_LTHM_TINY}}
    out = {"seconds": {}, "turn_ms": {}, "counts": {}, "per_step": None, "per_val_batch": None}
    for arm in arms:
        for seed in QUALITY_SEEDS:
            FakeDataStore.reset()
            write_synthetic_dataset(None, QUALITY_DATES, files_per_date=LTHM_TINY_FILES,
                                    users_per_file=LTHM_TINY_USERS, history_len=LTHM_TINY_HISTORY, seed=100 * seed,
                                    fake_store=True)
            tag = f"{arm}_{seed}"
            argv = ["--config-name", "lthm_tiny", "dataset.filesystem_config.kind=fake",
                    f"train.train_steps={LTHM_TINY_STEPS}", f"train.epochs={LTHM_TINY_EPOCHS}",
                    f"export.filesystem_config.local_dir_prefix={tmp}/export_{tag}",
                    f"trackers.trackers=[{{kind: jsonl, path: {tmp}/{tag}.jsonl}}]", f"model_version={tag}",
                    f"run_id=chip_smoke_{tag}", *(LTHM_TINY_KERNEL_ARGS if arm == "kernels" else ())]
            counted = (*kernels, *fc.ROUNDED_KERNELS)
            for kern in counted:
                kern.launches = 0
            t0 = time.perf_counter()
            with seeded_builder(LTHMModelBuilder, seed):
                pipeline, metrics = main_training.main(argv, return_pipeline=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = {kern.name: kern.launches for kern in counted}
            wrapper, state = pipeline._trained
            cfg = wrapper.config
            with open(f"{tmp}/{tag}.jsonl") as f:
                val_runs = sum(1 for line in f if '"val_loss"' in line)
            val_batches = val_runs * cfg_val_batches(pipeline)
            layers, heads = cfg.transformer_config.num_layers, len(cfg.lookahead)
            want = {kern.name: 0 for kern in counted}
            # the CE's rows, tokens per user and width (the heads' product_emb_dim), held by phase [2] in
            # both cases
            ce_shape = (cfg_batch(pipeline) * cfg.context_width, cfg.context_width,
                        cfg.product_tower.product_emb_dim)
            if ce_shape != LTHM_TINY_CE[:3]:
                raise AssertionError(f"phase [2] held the CE kernels at {LTHM_TINY_CE}, not at this arm's "
                                     f"shape {ce_shape}")
            if arm == "plain":  # the eager CE: one call a head over the batch, on the rounded case
                for kern in fc.ROUNDED_KERNELS:
                    per_val = heads if kern in (fc.CE_ROW_DIAG_ROUNDED, fc.CE_FWD_ROUNDED) else 0
                    want[kern.name] = heads * state.step + per_val * val_batches
            if arm == "kernels":
                shape = (cfg_batch(pipeline), cfg.context_width + 1, cfg.transformer_config.attn_config.n_head,
                         cfg.transformer_config.attn_config.n_embd // cfg.transformer_config.attn_config.n_head)
                if shape != LTHM_TINY_FLASH[:4]:
                    raise AssertionError(f"phase [2] held the kernels at {LTHM_TINY_FLASH}, not at this arm's "
                                         f"shape {shape}")
                per_step = {kern.name: 0 for kern in kernels}
                per_step.update({"flash_fwd": layers, "flash_bwd": layers, "ce_row_diag": heads, "ce_fwd": heads,
                                 "ce_dq": heads, "ce_dc": heads})
                per_val = {kern.name: 0 for kern in kernels}
                per_val.update({"flash_fwd": layers, "ce_row_diag": heads, "ce_fwd": heads})
                for name, n in per_step.items():
                    want[name] = n * state.step + per_val[name] * val_batches
            turns = np.asarray(metrics["step_times_s"][1:]) * 1e3
            out["seconds"][tag], out["turn_ms"][tag], out["counts"][tag] = seconds, float(np.median(turns)), counts
            print(f"[7] (a) lthm_tiny, {arm} arm, seed {seed}: {state.step} steps of {cfg_batch(pipeline)} users, "
                  f"{val_runs} validations of {cfg_val_batches(pipeline)} batches, {seconds:.1f} s (the loop's "
                  f"median turn {np.median(turns):.3f} ms); launches {counts} (expected {want}); val "
                  f"hit_rate@1/5/20 {metrics['val_hit_rate_at_1_lookahead_0']:.4f} / "
                  f"{metrics['val_hit_rate_at_5_lookahead_0']:.4f} / {metrics['val_hit_rate_at_20_lookahead_0']:.4f}, "
                  f"median hit position {metrics['val_median_hit_position_lookahead_0']}, val loss "
                  f"{metrics['val_loss']:.4f}, train loss {metrics['train_loss']:.4f}", flush=True)
            if counts != want:
                raise AssertionError(f"the lthm_tiny {arm} arm did not launch the kernels it should")
            if state.step != LTHM_TINY_STEPS:
                raise AssertionError(f"the lthm_tiny run stopped at step {state.step}")
            if arm == "kernels":
                step_counts, val_counts = step_and_val_launches(pipeline, kernels)
                print(f"[7] (a) lthm_tiny, kernels arm, seed {seed}: one more train_step of the trained model "
                      f"launches {step_counts} (expected {per_step}), one validation batch {val_counts} (expected "
                      f"{per_val})", flush=True)
                if (step_counts, val_counts) != (per_step, per_val):
                    raise AssertionError("a lthm_tiny step or validation batch did not launch the kernels it should")
                out["per_step"], out["per_val_batch"] = step_counts, val_counts
            for m in JAX_LTHM_TINY:
                arms[arm][m].append(float(metrics[m]))
            del pipeline, wrapper, state
            torch.cuda.empty_cache()
    FakeDataStore.reset()
    misses = []
    for arm, got in arms.items():
        misses += held_in_band(f"(a) {smi}: lthm_tiny {LTHM_TINY_STEPS} steps, {arm} arm vs JAX", got, JAX_LTHM_TINY)
    plain_ref = {m: (float(np.mean(v)), JAX_LTHM_TINY[m][1]) for m, v in arms["plain"].items()}
    misses += held_in_band(f"(a) {smi}: lthm_tiny, kernel arm vs the plain arm", arms["kernels"], plain_ref)
    out["arms"] = arms
    return out, misses


def step_and_val_launches(pipeline, kernels):
    """The launches of one validation batch and of one train_step on the
    trained model of ``pipeline``, each counted from 0, on the first batch
    of its validation files: ({kernel: step launches}, {kernel: validation
    launches})."""
    from recommendations_tpu_torch.data.generator import get_data_loader_strategy
    from recommendations_tpu_torch.data.loader import get_host_dataloader, to_device
    from recommendations_tpu_torch.data.paths import get_val_data_paths
    from recommendations_tpu_torch.train.step import train_step

    wrapper, state = pipeline._trained
    cfg = pipeline.pipeline_config
    feats = cfg.model.features
    strategy = get_data_loader_strategy(cfg.data_loader, feats.get_input_columns(),
                                        lambda kind: feats.default_data_mapper)
    host = next(iter(get_host_dataloader("val", 0, get_val_data_paths(cfg.dataset), cfg.train.batch_size, 1,
                                         strategy, feats, cfg.dataset.filesystem_config)))
    counted = []
    for run in (lambda: train_step(state, to_device(host, wrapper.device)),
                lambda: pipeline.training_strategy._run_val(state, [host], cfg.train)):
        for kern in kernels:
            kern.launches = 0
        run()
        torch.cuda.synchronize()
        counted.append({kern.name: kern.launches for kern in kernels})
    return counted[0], counted[1]


def quality_ranker(kernels, smi, tmp):
    """(b): main_training --config-name ranker_train at 400 steps (10 epochs
    end it at 320) at every seed on the port's synth impressions in the
    in-memory store; no kernel."""
    from recommendations_tpu_torch import main_training
    from recommendations_tpu_torch.data.data_store import FakeDataStore
    from recommendations_tpu_torch.models.ranker.builder import RankerModelBuilder
    from recommendations_tpu_torch.tools.synth_data import write_ranking_dataset

    got = {m: [] for m in JAX_RANKER}
    out = {"seconds": [], "turn_ms": [], "steps": []}
    try:
        for seed in QUALITY_SEEDS:
            FakeDataStore.reset()
            write_ranking_dataset(None, QUALITY_DATES, seed=100 * seed, fake_store=True)
            argv = ["--config-name", "ranker_train", "dataset.filesystem_config.kind=fake",
                    f"train.train_steps={RANKER_QUALITY_STEPS}", f"export.filesystem_config.local_dir_prefix={tmp}/ranker_export_{seed}",
                    f"trackers.trackers=[{{kind: jsonl, path: {tmp}/ranker_{seed}.jsonl}}]", f"model_version=r{seed}",
                    f"run_id=chip_smoke_ranker_{seed}"]
            for kern in kernels:
                kern.launches = 0
            t0 = time.perf_counter()
            with seeded_builder(RankerModelBuilder, seed):
                pipeline, metrics = main_training.main(argv, return_pipeline=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = {kern.name: kern.launches for kern in kernels}
            steps = pipeline._trained[1].step
            turns = np.asarray(metrics["step_times_s"][1:]) * 1e3
            out["seconds"].append(seconds)
            out["turn_ms"].append(float(np.median(turns)))
            out["steps"].append(steps)
            print(f"[7] (b) ranker_train, seed {seed}: {steps} steps of {cfg_batch(pipeline)}, {seconds:.1f} s (the "
                  f"loop's median turn {np.median(turns):.3f} ms); launches {counts}; val AUC click "
                  f"{metrics['val_auc_click']:.4f}, conversion {metrics['val_auc_conversion']:.4f}, val loss "
                  f"{metrics['val_loss']:.4f}", flush=True)
            if any(counts.values()):
                raise AssertionError("the ranker launched a kernel")
            for m in JAX_RANKER:
                got[m].append(float(metrics[m]))
    finally:
        FakeDataStore.reset()
    out["values"] = got
    return out, held_in_band(f"(b) {smi}: ranker_train {out['steps'][0]} steps vs JAX", got, JAX_RANKER)


def quality_joint(kernels, smi, tmp):
    """(c): main_training --config-name joint_train uncut: 4096 users, 6000
    lthm_tiny steps, then 10000 ranker steps in each of the two arms, its
    synthetic parquet and the enriched copies under ``tmp``."""
    from recommendations_tpu_torch import main_training

    jargs = ["--config-name", "joint_train", f"enriched_dir={tmp}/enriched", f"synth.root={tmp}/data"]
    for stage, src, test in (("retrieval", "clicks/*/*.parquet", "clicks/*/part-00000.parquet"),
                             ("ranking", "impressions/*/*.parquet", "impressions_val/*/*.parquet")):
        o = f"{stage}.overrides"
        jargs += [f"{o}.dataset.filesystem_config.local_dir_prefix={tmp}/data",
                  f"{o}.dataset.path_glob_train={tmp}/data/{src}", f"{o}.dataset.path_glob_test={tmp}/data/{test}"]
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    _, jm = main_training.main(jargs, return_pipeline=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {kern.name: kern.launches for kern in kernels}
    stages = {name: jm[key] for name, key in (("retrieval", "retrieval"), ("ranking", "ranking"),
                                               ("ablated", "ranking_ablated"))}
    turn_ms = {name: float(np.median(np.asarray(m["step_times_s"][1:]) * 1e3)) for name, m in stages.items()}
    steps = {name: int(m["train_steps_total"]) for name, m in stages.items()}
    with_emb, ablated = stages["ranking"]["val_auc_click"], stages["ablated"]["val_auc_click"]
    uplift = jm["auc_uplift_click"]
    print(f"[7] (c) {smi}: main_training --config-name joint_train uncut: {seconds:.1f} s; steps {steps}, the loops' "
          f"median turns {json.dumps({k: round(v, 3) for k, v in turn_ms.items()})} ms; launches {counts} (the "
          f"config's lthm_tiny takes no kernel); retrieval train loss {stages['retrieval']['train_loss']:.4f}; "
          f"held-out-user val AUC (click) with the embeddings {with_emb:.4f}, ablated {ablated:.4f}", flush=True)
    if any(counts.values()):
        raise AssertionError("joint_train's lthm_tiny launched a kernel its YAML does not ask for")
    misses = held_in_band(f"(c) {smi}: joint_train seed 0 vs JAX",
                          {"val_auc_click_with_embeddings": [with_emb], "auc_uplift_click": [uplift]}, JAX_JOINT)
    lo, hi = JOINT_UPLIFT_RANGE
    ok = lo <= uplift <= hi
    print(f"[7] (c) {smi}: joint auc_uplift_click {uplift:.4f} in QUALITY.md's range [{lo}, {hi}] -> "
          f"{'ok' if ok else 'MISS'}", flush=True)
    if not ok:
        misses.append("(c) auc_uplift_click outside QUALITY.md's range")
    return {"seconds": seconds, "turn_ms": turn_ms, "steps": steps, "with_embeddings": with_emb,
            "ablated": ablated, "uplift": uplift}, misses


def quality_phase(kernels, smi):
    """Phase [7]: the runs QUALITY.md records, at their full length, through
    main_training, each metric held to the JAX package's figure on the CPU
    (tools/quality_reference.py) within its band; any miss fails the run."""
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_quality_")
    try:
        tiny, misses = quality_lthm_tiny(kernels, smi, tmp)
        ranker, m_ranker = quality_ranker(kernels, smi, tmp)
        misses += m_ranker
        joint, m_joint = quality_joint(kernels, smi, f"{tmp}/joint")
        misses += m_joint
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"[7] the phase took {seconds:.1f} s: (a) {sum(tiny['seconds'].values()):.1f} s, (b) "
          f"{sum(ranker['seconds']):.1f} s, (c) {joint['seconds']:.1f} s", flush=True)
    if misses:
        raise AssertionError(f"[7] outside the band: {misses}")
    return {"lthm_tiny": tiny, "ranker": ranker, "joint": joint, "seconds": seconds}



def phase_took(phase: int, t0: float) -> float:
    """Prints the phase's seconds since ``t0``; returns the time now."""
    now = time.perf_counter()
    print(f"[{phase}] the phase took {now - t0:.1f} s", flush=True)
    return now


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
    from recommendations_tpu_torch.models.lthm.loss import sample_offsets
    from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
    from recommendations_tpu_torch.ops import fused_attention as fa
    from recommendations_tpu_torch.ops import fused_ce as fc
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
    kernels = (*fa.KERNELS, *fc.KERNELS)
    built = (*kernels, *fc.ROUNDED_KERNELS)  # the rounded case: a library of its own
    with ThreadPoolExecutor(len(built)) as pool:  # one nvcc per source, all at once
        list(pool.map(lambda kern: kern.build(), built))
    sources = {kern.source: kern for kern in built}
    print(f"[1] built {', '.join(src.name for src in sources)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for src, kern in sources.items():
        entry = ""
        for line in kern.build_log.splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                base = re.search(r"[a-z_]*kernel[a-z_]*", mangled)
                entry = (base.group(0) if base else mangled) + "<" + ",".join(re.findall(r"L[ib](\d+)E", mangled)) + ">"
            elif "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                print(f"    {src.name} {entry}: " + line.split(":", 1)[-1].strip(), flush=True)

    # -- 2. kernel against its plain version -----------------------------------
    t_phase = time.perf_counter()
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
        (16, 1025, 32, 16, 1, torch.bfloat16, True),   # the long-history shape: 17 tiles a block
        (32, 450, 32, 16, 1, torch.bfloat16, True),
        (2, 1025, 32, 16, 1, torch.bfloat16, True),    # ragged last tiles
        (2, 1026, 32, 16, 1, torch.bfloat16, False),
        (2, 1, 32, 16, 1, torch.bfloat16, True),       # one row
    ):
        compare_flash(fa, *shape)
    print(f"[2] flash_fwd at lthm_tiny's kernel arm (phase [7]): {LTHM_TINY_FLASH}:", flush=True)
    tiny_fwd_err, _, tiny_fwd_tol = compare_flash(fa, *LTHM_TINY_FLASH)
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
        (16, 1025, 32, 16, 1, torch.bfloat16, True),   # the long-history shape: several items a block
        (32, 450, 32, 16, 1, torch.bfloat16, True),
        (2, 1025, 32, 16, 1, torch.bfloat16, True),    # ragged last key block
        (2, 1026, 32, 16, 1, torch.bfloat16, False),
        (2, 1, 32, 16, 1, torch.bfloat16, True),       # one row
    ):
        compare_flash_bwd(fa, *shape)
    print(f"[2] flash_bwd at lthm_tiny's kernel arm: {LTHM_TINY_FLASH}:", flush=True)
    tiny_bwd_err, tiny_bwd_tol = compare_flash_bwd(fa, *LTHM_TINY_FLASH)
    print("[2] flash attention with the position bias (forward, dQ, dK/dV and the table gradient) "
          "against the plain versions:", flush=True)
    prod_t = PROD_CONTEXT + 1
    # the production path's shape (64 users: a dK/dV block walks several batch rows)
    bias_errs = compare_flash_bias(fa, BATCH, prod_t, 32, 16, 1, torch.bfloat16, True, prod_t)
    for shape in (
        (4, prod_t, 32, 16, 1, torch.bfloat16, True, prod_t),  # one batch row a block
        (BATCH, CTX512 + 1, 32, 16, 1, torch.bfloat16, True, CTX512 + 1),  # production at context 512
        (45, 768, 32, 16, 1, torch.bfloat16, True, 768),    # a last block of fewer batch rows
        (20, 1025, 32, 16, 1, torch.bfloat16, False, 1024),  # non-causal, several rows a block
        (2, 768, 32, 16, 1, torch.bfloat16, True, 768),     # BIAS_MIN_SEQ
        (2, 1000, 32, 16, 1, torch.bfloat16, True, 1000),   # no tile multiple
        (2, 900, 32, 16, 1, torch.bfloat16, True, 1200),    # nk > T
        (3, 800, 32, 16, 1, torch.bfloat16, False, 800),    # non-causal; batch not a multiple of 4
        (2, 800, 32, 16, 32, torch.bfloat16, True, 800),    # MHA: FMA kernels
        (2, 800, 4, 16, 1, torch.float32, True, 800),       # float32: FMA kernels
        (2, 300, 16, 64, 1, torch.bfloat16, False, 300),    # tensor cores at hd 64
        (2, 1026, 48, 16, 1, torch.bfloat16, True, 1026),   # 3 and 4 groups of 16 heads: the one-pass forward
        (2, 768, 64, 16, 1, torch.bfloat16, True, 768),
        (2, 300, 256, 16, 1, torch.bfloat16, True, 300),    # 16 groups: the two-pass tensor-core forward
    ):
        compare_flash_bias(fa, *shape)
    print("[2] fused CE kernels against their plain versions:", flush=True)
    n_ce, d_ce = (BATCH // 2) * CONTEXT, 128  # one 32-user loss chunk of LTHM-base
    ce_errs, ce_tols = compare_ce(fc, n_ce, CONTEXT, d_ce, 0.0, "roll")
    for shape in (
        (100, 10, 16, 1.0, "random"),            # N not a multiple of any tile
        (32 * 264, 264, 128, 0.0, "roll"),       # N = 8448, a 264-token context
        (2048, 64, 64, 1.0, "invalid_user"),     # a user with every slot invalid
        (1024, 32, 32, 0.5, "random"),
        (512, 32, 16, 1.0, "one_user"),          # fully masked rows: ce = -inf
        (256, 256, 128, 1.0, "random"),          # one user: every off-diagonal masked
        (32 * PROD_CONTEXT, PROD_CONTEXT, 128, 0.0, "roll"),  # a chunk of the production path
        (32 * CTX512, CTX512, 128, 0.0, "roll"),  # a chunk of the production path at context 512
        (17000, 1000, 64, 1.0, "random"),        # 128-row blocks (no split), ragged last stage
    ):
        compare_ce(fc, *shape)
    print("[2] the CE kernels' rounded case (the eager CE's function) against the rounded plain versions:",
          flush=True)
    for shape in (
        (32 * CTX512, CTX512, 128, 0.0, "roll"),  # lthm_train.yaml's chunk at context 512
        (17000, 1000, 64, 1.0, "random"),         # 128-row blocks, ragged last block and stage
        (8448, 264, 32, 0.5, "invalid_user"),     # the stream split, a user with every slot invalid
        (512, 32, 16, 1.0, "one_user"),           # fully masked rows: ce = -inf
        (n_ce, CONTEXT, d_ce, 0.0, "roll"),       # phase [4]'s eager step: a 32-user chunk
        LTHM_TINY_CE,                             # phase [7]'s plain arm
    ):
        compare_ce(fc, *shape, rounded=True)
    print(f"[2] the CE kernels at lthm_tiny's kernel arm: {LTHM_TINY_CE}:", flush=True)
    tiny_ce_errs, tiny_ce_tols = compare_ce(fc, *LTHM_TINY_CE)
    tiny_errs = {"flash_fwd": (tiny_fwd_err, tiny_fwd_tol), "flash_bwd": (tiny_bwd_err, tiny_bwd_tol),
                 **{name: (tiny_ce_errs[name], tiny_ce_tols[name]) for name in tiny_ce_errs}}
    torch.cuda.empty_cache()
    t_phase = phase_took(2, t_phase)
    # phase [7] runs here, in a process that has not yet run phases [3]-[6]: its loops are host-bound (a
    # lthm_tiny step is about 30 ms of host time), and after those phases they ran about 30% slower
    quality = quality_phase(kernels, smi)
    t_phase = time.perf_counter()

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
    prod, prod_serving = serve_production(fa, kernels)
    t_phase = phase_took(3, t_phase)

    # -- 4. the training path -------------------------------------------------
    del models, outs, seq, seq_plain
    torch.cuda.empty_cache()
    state = TrainState.create(wrapper, seed=1)
    table = wrapper.module.product_emb_module.embedding
    table_before = table.detach().clone()
    train_batch = request_batch(1000)
    offsets = sample_offsets(torch.Generator().manual_seed(5), cfg.lookahead)
    heads, chunks = len(cfg.lookahead), BATCH // cfg.train_mini_batch_size

    def timed_steps(steps, counted=kernels):
        """Steps on the training batch with the launch count of every kernel
        of ``counted`` set to 0 just before and read just after: (ms, losses,
        grad norms, NaN flags, {kernel: launches}, peak MiB)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kern in counted:
            kern.launches = 0
        ms, ls, gn, nan = [], [], [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss, metrics = train_step(state, train_batch, offsets=offsets)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            ls.append(loss.item())
            gn.append(metrics["grad_norm"].item())
            nan.append(metrics["params_nan"].item())
        counts = {kern.name: kern.launches for kern in counted}
        return ms, ls, gn, nan, counts, torch.cuda.max_memory_allocated() / 2**20

    first_loss, _ = train_step(state, train_batch, offsets=offsets)  # warm-up, step 1
    first_loss = first_loss.item()
    step_ms, losses, grad_norms, nans, train_counts, train_peak_mib = timed_steps(TRAIN_STEPS)
    want = {k.name: 0 for k in kernels}
    want.update({"flash_fwd": layers, "flash_bwd": layers, **{k.name: heads * chunks for k in fc.KERNELS}})
    print(f"[4] {TRAIN_STEPS} training steps of {BATCH} users, fused_ce on (offsets "
          f"{offsets.tolist()}): launches {train_counts} (expected per step {want})", flush=True)
    if train_counts != {k: n * TRAIN_STEPS for k, n in want.items()}:
        raise AssertionError("the training step did not launch each kernel of its path as expected")
    print(f"[4] loss: step 1 {first_loss:.5f}, steps 2-9 {[round(x, 5) for x in losses]}; "
          f"grad_norm {[round(x, 4) for x in grad_norms]}; params_nan {nans}", flush=True)
    if not all(np.isfinite(losses + grad_norms + [first_loss])) or any(nans):
        raise AssertionError("a training step gave a non-finite loss or gradient, or NaN parameters")
    if not torch.equal(table, table_before):
        raise AssertionError("the frozen product-embedding table changed")
    if not losses[-1] < first_loss:
        raise AssertionError("the loss did not fall over 8 steps on one batch")

    # one step's gradients on the kernel path, against the same step with the
    # plain attention, with the plain CE, and with the eager CE
    loss_k, grads_k = grads_of(wrapper, train_batch, state.aux, offsets)
    before = {kern.name: kern.launches for kern in kernels}
    with mock.patch.object(fa, "fused_flash_attention_fwd", fa.fused_flash_attention_reference), \
            mock.patch.object(fa, "fused_flash_attention_bwd", fa.fused_flash_attention_bwd_reference):
        plain_attention = grads_of(wrapper, train_batch, state.aux, offsets)
    if (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches) != (before["flash_fwd"], before["flash_bwd"]):
        raise AssertionError("the plain-attention run launched a flash kernel")
    held_to("kernel vs plain attention", plain_attention, grads_k, loss_k, 2**-5, 2**-8 * abs(loss_k),
            "one-ulp flips in o, dq, dk, dv travel through 6 layers of bf16 products: "
            "2**-5 (four ulps), the loss 2**-8 relative")
    del plain_attention
    before = {kern.name: kern.launches for kern in kernels}
    with mock.patch.object(fc, "ce_forward", fc.ce_forward_reference), \
            mock.patch.object(fc, "ce_backward", fc.ce_backward_reference):
        plain_ce = grads_of(wrapper, train_batch, state.aux, offsets)
    if any(k.launches != before[k.name] for k in fc.KERNELS):
        raise AssertionError("the plain-CE run launched a CE kernel")
    held_to("kernel vs plain CE", plain_ce, grads_k, loss_k, 2**-7, 1e-5 * abs(loss_k),
            "the two differ by f32 sum order and exp's last bits, which can move one bf16 "
            "rounding of g or of dq, dc: one ulp, 2**-7 relative at most")
    del plain_ce
    eager_cfg = dataclasses.replace(cfg, fused_ce=False)
    wrapper.config = eager_cfg
    eager = grads_of(wrapper, train_batch, state.aux, offsets)
    wrapper.config = cfg
    held_to("fused vs eager CE", eager, grads_k, loss_k, 2**-3, heads * 2**-4,
            "the eager CE stores its logits in bf16, each within half a quantum (2**-5 at "
            "|logit| <= 20), so each row's lse and diagonal move by at most 2**-5 (ce by "
            "2**-4 a head) and each p by at most 6.5%")
    del grads_k, eager

    # the eager CE's step (fused_ce off) on the same state: the CE kernels' rounded case
    wrapper.config = eager_cfg
    train_step(state, train_batch, offsets=offsets)  # warm-up
    with_rounded = (*kernels, *fc.ROUNDED_KERNELS)
    eager_ms, eager_losses, eager_gn, eager_nans, eager_counts, eager_peak_mib = timed_steps(EAGER_STEPS,
                                                                                           with_rounded)
    wrapper.config = cfg
    want_eager = {k.name: (layers if k in (fa.FLASH_FWD, fa.FLASH_BWD) else
                           heads * chunks if k in fc.ROUNDED_KERNELS else 0) for k in with_rounded}
    print(f"[4] {EAGER_STEPS} training steps, fused_ce off: launches {eager_counts} (expected per "
          f"step {want_eager}); loss {[round(x, 5) for x in eager_losses]}", flush=True)
    if eager_counts != {k: n * EAGER_STEPS for k, n in want_eager.items()}:
        raise AssertionError("the eager-CE step did not launch each kernel of its path as expected")
    if not all(np.isfinite(eager_losses + eager_gn)) or any(eager_nans):
        raise AssertionError("an eager-CE step gave a non-finite loss or gradient, or NaN parameters")

    # a small float32 model: one step on the card against one on the CPU,
    # with either CE
    for fused in (True, False):
        train_small = dict(small, log_q_config={"num_buckets": 4096, "hash_offsets": [0, 7]},
                           train_mini_batch_size=3, fused_ce=fused)
        small_cfg = LTHMModelConfig.from_dict(train_small)
        on_card = LTHMModelWrapper(small_cfg, device="cuda", seed=2)
        on_cpu = LTHMModelWrapper(small_cfg, device="cpu")
        on_cpu.module.load_state_dict({k: v.cpu() for k, v in on_card.module.state_dict().items()})
        sb = request_batch(98, batch=4, events=56)
        small_offsets = sample_offsets(torch.Generator().manual_seed(3), small_cfg.lookahead)
        results = []
        before = fc.CE_FWD.launches
        for w in (on_card, on_cpu):
            st = TrainState.create(w, seed=1)
            st.optimizer.zero_grad()
            loss_s, _, _ = w.loss_and_metrics(sb, st.aux, True, offsets=small_offsets)
            loss_s.backward()
            grads = {n: p.grad.detach().cpu().clone() for n, p in w.module.named_parameters() if p.grad is not None}
            st.optimizer.step()
            after = {n: p.detach().cpu() for n, p in w.module.named_parameters()}
            results.append((loss_s.item(), grads, after))
        if (fc.CE_FWD.launches > before) != fused:
            raise AssertionError("the small model's card step did not take the CE it was given")
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
        print(f"[4] small f32 model, fused_ce {'on' if fused else 'off'}, one training step, card vs "
              f"CPU: loss {lc:.6f} vs {lp:.6f}; worst gradient {worst_g[1]} at {worst_g[0]:.3f} of its "
              f"tolerance, worst updated parameter {worst_p[1]} at {worst_p[0]:.3f} of its tolerance "
              f"-> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError("the card and the CPU disagree on the small model's training step")
    del state, on_card, on_cpu
    torch.cuda.empty_cache()
    prod_training = train_production(fa, fc, kernels, prod)
    del prod
    torch.cuda.empty_cache()
    long_path = long_history(fa, kernels)
    torch.cuda.empty_cache()
    base_tables = trainable_base(fa, fc, kernels)
    prod_tables = trainable_production(fa, fc, kernels)
    ctx512 = production_512(fa, fc, kernels)
    trainer = trainer_path(fa, kernels, smi)
    torch.cuda.empty_cache()
    knobs = trainer_knobs(fa, fc, kernels, ctx512["fused"]["per_step"])
    torch.cuda.empty_cache()
    moe = moe_path(fa, fc, kernels)
    sparse = sparse_long_history(fa, kernels)
    ranker = ranker_path(kernels)
    torch.cuda.empty_cache()
    extras = pipeline_extras(fa, kernels, smi)
    torch.cuda.empty_cache()
    t_phase = phase_took(4, t_phase)

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
    # version, and the backward of scaled_dot_product_attention on expanded
    # K/V: at the training shape, and in the JAX package's two-kernel
    # (384 < T <= 512) and grid (T > 512) regimes
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def time_flash_bwd(b, t, seed, plain_iters):
        q, k, v, o, lse, do = bwd_inputs(fa, b, t, h, hd, kvh, dt, causal, seed=seed)
        dcol = fa._rowsum_do_o(do, o, h).contiguous()
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        stream = torch.cuda.current_stream().cuda_stream

        def bwd_kernel():
            fa.FLASH_BWD.launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                dcol.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, t, h, kvh, hd, int(causal), 1, stream,
            )

        ms = cuda_ms(bwd_kernel, 30)
        plain = cuda_ms(lambda: fa.fused_flash_attention_bwd_reference(q, k, v, o, lse, do, h, causal),
                        plain_iters, warmup=1)
        qh = q.view(b, t, h, hd).transpose(1, 2).detach().requires_grad_()
        kh = k.view(b, t, 1, hd).transpose(1, 2).detach().requires_grad_()
        vh = v.view(b, t, 1, hd).transpose(1, 2).detach().requires_grad_()
        doh = do.view(b, t, h, hd).transpose(1, 2)

        def sdpa_fwd():
            with torch.no_grad():
                sdpa(qh, kh.expand(b, h, t, hd), vh.expand(b, h, t, hd), is_causal=True)

        def sdpa_fwd_bwd():
            out = sdpa(qh, kh.expand(b, h, t, hd), vh.expand(b, h, t, hd), is_causal=True)
            torch.autograd.grad(out, (qh, kh, vh), doh)

        # the library's backward: device time (profiler) of forward + backward
        # less the forward's, and the same on CUDA events (host gaps included)
        library = device_ms(sdpa_fwd_bwd) - device_ms(sdpa_fwd)
        library_events = cuda_ms(sdpa_fwd_bwd, 20) - cuda_ms(sdpa_fwd, 20)
        bound, by, nbytes, flops = flash_bwd_bound(b, t, h, hd, kvh, dt, causal)
        print(f"[5] flash_bwd at B={b} T={t} MQA {h}x{hd} bf16 causal: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, scaled_dot_product_attention backward {library:.4f} ms of device "
              f"time ({library_events:.4f} ms on events), bound {bound:.4f} ms ({by}: {nbytes} bytes, "
              f"{flops} flop)", flush=True)
        return {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": library,
                "library_event_ms": library_events}

    bwd_times = time_flash_bwd(b, t, 8, 5)
    bwd_t450 = time_flash_bwd(32, 450, 10, 3)
    bwd_t1025 = time_flash_bwd(16, 1025, 11, 2)
    bwd_t512 = time_flash_bwd(LONG_BATCH, sparse["kept"], 15, 3)  # the sparse long-history path's shape

    # the forward at T > 512 (the no-bias _fwd_kernel_grid's lengths)
    lb, lt = 16, 1025
    q, k, v = randn_qkv(lb, lt, h, hd, 1, dt, seed=9)
    long_ms = cuda_ms(lambda: fa.fused_flash_attention_fwd(q, k, v, h, True), 20)
    long_plain_ms = cuda_ms(lambda: fa.fused_flash_attention_reference(q, k, v, h, True), 2, warmup=1)
    qh = q.view(lb, lt, h, hd).transpose(1, 2)
    kh = k.view(lb, lt, 1, hd).transpose(1, 2).expand(lb, h, lt, hd)
    vh = v.view(lb, lt, 1, hd).transpose(1, 2).expand(lb, h, lt, hd)
    long_library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True), 20)
    long_bound_ms, long_bound_by, _, _ = flash_bound(lb, lt, h, hd, 1, dt, True)
    print(f"[5] flash_fwd at B={lb} T={lt} MQA {h}x{hd} bf16 causal: kernel {long_ms:.4f} ms, "
          f"plain {long_plain_ms:.4f} ms, scaled_dot_product_attention {long_library_ms:.4f} ms, "
          f"bound {long_bound_ms:.4f} ms ({long_bound_by})", flush=True)
    # and at the sparse long-history path's T = 512
    sq, sk, sv = randn_qkv(LONG_BATCH, sparse["kept"], h, hd, 1, dt, seed=16)
    s512 = {"ms": cuda_ms(lambda: fa.fused_flash_attention_fwd(sq, sk, sv, h, True), 20),
            "plain_ms": cuda_ms(lambda: fa.fused_flash_attention_reference(sq, sk, sv, h, True), 3, warmup=1)}
    sqh = sq.view(LONG_BATCH, -1, h, hd).transpose(1, 2)
    skh = sk.view(LONG_BATCH, -1, 1, hd).transpose(1, 2).expand(-1, h, -1, -1)
    svh = sv.view(LONG_BATCH, -1, 1, hd).transpose(1, 2).expand(-1, h, -1, -1)
    s512["library_ms"] = cuda_ms(lambda: sdpa(sqh, skh, svh, is_causal=True), 20)
    s512["bound_ms"], s512["bound_by"], _, _ = flash_bound(LONG_BATCH, sparse["kept"], h, hd, 1, dt, True)
    print(f"[5] flash_fwd at B={LONG_BATCH} T={sparse['kept']} MQA {h}x{hd} bf16 causal (the sparse long-history "
          f"path): kernel {s512['ms']:.4f} ms, plain {s512['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"{s512['library_ms']:.4f} ms, bound {s512['bound_ms']:.4f} ms ({s512['bound_by']})", flush=True)
    del q, k, v, qh, kh, vh, sq, sk, sv, sqh, skh, svh
    torch.cuda.empty_cache()

    # the CE kernels at the path's shape (one 32-user chunk, beta as
    # LTHM-base's), each alone with its inputs ready, and its plain version
    # (ce_row_diag also beside torch.linalg.vecdot, a yardstick). The
    # rounded case (the eager setting's route on the card) on the same
    # problem beside them.
    beta = cfg.log_q_config.beta
    ce_times = time_ce(fc, n_ce, CONTEXT, d_ce, beta)
    q, c, v, lq, dce = ce_inputs(n_ce, CONTEXT, d_ce, "roll", seed=12)
    _, _, lse = fc.ce_forward(q, c, v, lq, CONTEXT, INV_T, beta)
    fused_fwd_ms = cuda_ms(lambda: fc.ce_forward(q, c, v, lq, CONTEXT, INV_T, beta), 30)
    fused_bwd_ms = cuda_ms(lambda: fc.ce_backward(q, c, v, lq, lse, dce, CONTEXT, INV_T, beta), 30)
    rounded_fwd_ms = cuda_ms(lambda: fc.ce_forward(q, c, v, lq, CONTEXT, INV_T, beta, True), 30)
    rounded_bwd_ms = cuda_ms(lambda: fc.ce_backward(q, c, v, lq, lse, dce, CONTEXT, INV_T, beta, True), 30)
    print(f"[5] the CE on one (N={n_ce}, D={d_ce}) chunk: fused forward {fused_fwd_ms:.4f} ms "
          f"(ce_row_diag with the shift, ce_fwd), backward {fused_bwd_ms:.4f} ms (ce_dq, ce_dc); rounded "
          f"case forward {rounded_fwd_ms:.4f} ms, backward {rounded_bwd_ms:.4f} ms", flush=True)
    del q, c, v, lq, dce, lse
    torch.cuda.empty_cache()
    # the production chunk (32 users of 1024 tokens): the CE kernels' shape
    # on the production step
    prod_beta = LTHMModelConfig.from_dict(production_config()).log_q_config.beta
    ce_times_prod = time_ce(fc, 32 * PROD_CONTEXT, PROD_CONTEXT, d_ce, prod_beta, plain_iters=1)
    ce_times_512 = time_ce(fc, 32 * CTX512, CTX512, d_ce, prod_beta, plain_iters=1)
    # and the rounded case there: lthm_train.yaml's eager CE on the card
    ce_times_512_rounded = time_ce(fc, 32 * CTX512, CTX512, d_ce, prod_beta, plain_iters=1, rounded=True)

    print(f"[5] user_encoder request ({BATCH} users): median {med:.3f} ms, "
          f"min {min(request_ms):.3f} ms, max {max(request_ms):.3f} ms; "
          f"{BATCH / (med / 1e3):.1f} users/s; peak device memory {peak_mib:.1f} MiB", flush=True)
    for label, ms_list, peak in (("fused_ce on", step_ms, train_peak_mib),
                                 ("fused_ce off", eager_ms, eager_peak_mib)):
        step_med = float(np.median(ms_list))
        print(f"[5] training step ({BATCH} users, {label}): median {step_med:.3f} ms, min "
              f"{min(ms_list):.3f} ms, max {max(ms_list):.3f} ms over {len(ms_list)} steps; "
              f"{BATCH / (step_med / 1e3):.1f} examples/s; peak device memory {peak:.1f} MiB", flush=True)

    for label, ms_list, unit in (("request", long_path["request_ms"], "users"),
                                 ("training step (eager CE, remat)", long_path["step_ms"], "examples")):
        med_l = float(np.median(ms_list))
        print(f"[5] long-history {label} ({LONG_BATCH} users, T={LONG_CONTEXT + 1}): median {med_l:.3f} ms, "
              f"min {min(ms_list):.3f} ms, max {max(ms_list):.3f} ms over {len(ms_list)}; "
              f"{LONG_BATCH / (med_l / 1e3):.1f} {unit}/s", flush=True)
    print(f"[5] long-history peak device memory (training) {long_path['peak_mib']:.1f} MiB", flush=True)
    long_json = {"request_median_ms": float(np.median(long_path["request_ms"])),
                 "step_median_ms": float(np.median(long_path["step_ms"])),
                 "launches_per_request": long_path["launches_per_request"],
                 "launches_per_step": long_path["launches_per_step"]}

    bias_times, crossover = time_production(fa, prod_serving, prod_training)
    sweep = bias_sweep(fa)

    # the new paths' requests and steps
    base_frozen = float(np.median(step_ms))
    for opt, res in base_tables.items():
        print(f"[5] LTHM-base training step, table_optimizer {opt} ({BATCH} users, fused_ce on): median "
              f"{res['median_ms']:.3f} ms (frozen table {base_frozen:.3f} ms in this run), min {min(res['step_ms']):.3f}, "
              f"max {max(res['step_ms']):.3f} over {len(res['step_ms'])}; {BATCH / (res['median_ms'] / 1e3):.1f} "
              f"examples/s; the table update alone {res['update_ms']:.4f} ms; peak device memory "
              f"{res['peak_mib']:.1f} MiB", flush=True)
    prod_frozen = float(np.median(prod_training["step_ms"]))
    for opt, res in prod_tables.items():
        print(f"[5] production training step at context {PROD_CONTEXT}, 10M-row table, {opt}: median "
              f"{res['median_ms']:.3f} ms (frozen table {prod_frozen:.3f} ms in this run), min {min(res['step_ms']):.3f}, "
              f"max {max(res['step_ms']):.3f} over {len(res['step_ms'])}; {BATCH / (res['median_ms'] / 1e3):.1f} "
              f"examples/s; the table update alone {res['update_ms']:.4f} ms; peak device memory "
              f"{res['peak_mib']:.1f} MiB", flush=True)
    print(f"[5] production user_encoder request at context {CTX512} ({BATCH} users, T={CTX512 + 1}, CUDA dispatch): "
          f"median {ctx512['request_median_ms']:.3f} ms, min {min(ctx512['request_ms']):.3f}, max "
          f"{max(ctx512['request_ms']):.3f}; {BATCH / (ctx512['request_median_ms'] / 1e3):.1f} users/s; peak "
          f"device memory {ctx512['serve_peak_mib']:.1f} MiB", flush=True)
    for label, res in (("CUDA dispatch, fused bias kernels", ctx512["fused"]),
                       ("the JAX package's dispatch, _sdpa with the bias", ctx512["sdpa"])):
        print(f"[5] production training step at context {CTX512} ({label}): median {res['median_ms']:.3f} ms "
              f"over {len(res['step_ms'])} ({[round(x, 3) for x in res['step_ms']]}); "
              f"{BATCH / (res['median_ms'] / 1e3):.1f} examples/s; peak device memory {res['peak_mib']:.1f} MiB",
              flush=True)
    tr_med = trainer["median_ms"]
    print(f"[5] {smi}: the trainer loop (main_training on lthm_train.yaml, context {CTX512}, eager CE, "
          f"{trainer['batch']} users a step): median step {tr_med:.3f} ms over the {trainer['plain_turns']} turns "
          f"that neither validate, checkpoint nor log, after the first (all turns "
          f"{[round(x, 3) for x in trainer['turn_ms']]}, median {trainer['all_median_ms']:.3f}; turns 4 and 8 "
          f"also log, validate, checkpoint and export); {trainer['batch'] / (tr_med / 1e3):.1f} examples/s; peak "
          f"device memory {trainer['peak_mib']:.1f} MiB; waiting for the feed {100 * trainer['feed_wait_share']:.2f}% "
          f"of the loop; train_step called directly on one batch of the same model: median "
          f"{trainer['direct']['median_ms']:.3f} ms ({[round(x, 3) for x in trainer['direct']['step_ms']]}), peak "
          f"{trainer['direct']['peak_mib']:.1f} MiB (the context-{CTX512} phase's step at fused_ce on: "
          f"{ctx512['fused']['median_ms']:.3f} ms); the run {trainer['seconds']:.1f} s, the resumed run "
          f"{trainer['resume_seconds']:.1f} s", flush=True)
    print(f"[5] trainer feed-path stage timers: {json.dumps(trainer['stages'])}", flush=True)
    print(f"[5] {smi}: the trainer with every knob (lthm_train.yaml, context {CTX512}, fused CE, dropout 0.1, "
          f"accumulation 2, process reader, grouping with a shuffle buffer; run B, one step a dispatch): median "
          f"step {knobs['median_ms']:.3f} ms over the {knobs['plain_turns']} turns that neither log nor warm up "
          f"(min {knobs['min_ms']:.3f}, max {knobs['max_ms']:.3f}; all turns "
          f"{[round(x, 3) for x in knobs['turn_ms']]}); {BATCH / (knobs['median_ms'] / 1e3):.1f} examples/s; "
          f"waiting for the feed {100 * knobs['feed_wait_share']:.2f}% of the loop after the first turn (the "
          f"first turn's wait, the spawned reader's start, {knobs['first_wait_ms']:.1f} ms); peak device memory "
          f"{knobs['peak_mib']:.1f} MiB (run A, two steps a dispatch, checkpoints and profile, turns "
          f"{[round(x, 3) for x in knobs['turn_a_ms']]}; run B's peak {knobs['peak_b_mib']:.1f} MiB counts "
          f"run A's state, still held); runs A, B, C "
          f"{[round(x, 1) for x in knobs['seconds']]} s; the masks kept {knobs['keep_rate']:.6f}", flush=True)
    print(f"[5] the knobs trainer's feed-path stage timers: {json.dumps(knobs['stages'])}", flush=True)
    for label, res, users in (("MoE LTHM (context 512, T = 513, fused CE)", moe, BATCH),
                              (f"sparse long-history (T = {sparse['kept']} a block of {LONG_CONTEXT + 1})", sparse,
                               LONG_BATCH)):
        tr = res["train"]
        print(f"[5] {smi}: {label} request ({users} users): median {res['request_median_ms']:.3f} ms "
              f"({[round(x, 3) for x in res['request_ms']]}), {users / (res['request_median_ms'] / 1e3):.1f} users/s; "
              f"training step: median {tr['median_ms']:.3f} ms ({[round(x, 3) for x in tr['step_ms']]}), "
              f"{users / (tr['median_ms'] / 1e3):.1f} examples/s, peak device memory {tr['peak_mib']:.1f} MiB",
              flush=True)
    print(f"[5] {smi}: the ranker trainer (main_training on ranker_train.yaml, {ranker['batch']} rows a step, "
          f"{ranker['n_params']} parameters): median step {ranker['median_ms']:.3f} ms over the "
          f"{ranker['plain_turns']} turns that neither log, validate nor checkpoint, after the first (all turns "
          f"{[round(x, 3) for x in ranker['turn_ms']]}); {ranker['batch'] / (ranker['median_ms'] / 1e3):.1f} "
          f"examples/s; waiting for the feed {100 * ranker['feed_wait_share']:.2f}% of the loop; peak device memory "
          f"{ranker['peak_mib']:.1f} MiB; train_step called directly {[round(x, 3) for x in ranker['direct_ms']]} ms; "
          f"the run {ranker['seconds']:.1f} s, the resumed run {ranker['resume_seconds']:.1f} s", flush=True)
    job = extras["job"]
    print(f"[5] {smi}: the pipeline extras of lthm_train.yaml (context {CTX512}): main_training with the KNN eval, "
          f"the batch inference and the traced export {extras['seconds']:.1f} s; the KNN eval {extras['knn_s']:.2f} s, "
          f"recall {extras['recall']}; catalog encode {extras['encode_ms_per_8192']:.3f} ms per 8192 ids; inference "
          f"{extras['inference_users_per_s']:.1f} users/s; export trace/save "
          f"{json.dumps({k: round(v, 2) for k, v in extras['export_seconds'].items()})} s; a .pt2 call "
          f"{json.dumps({k: round(v, 3) for k, v in extras['program_ms'].items()})} ms against the eager "
          f"{json.dumps({k: round(v, 3) for k, v in extras['eager_ms'].items()})} ms; the compression job "
          f"{job['reconstruction_s'] / PIPE_RECON_EPOCHS:.3f} s a reconstruction epoch, "
          f"{job['mask_s'] / PIPE_MASK_EPOCHS:.3f} s a mask epoch", flush=True)
    paths = {
        **{f"base_{opt}": res["per_step"] for opt, res in base_tables.items()},
        **{f"prod1024_{opt}": res["per_step"] for opt, res in prod_tables.items()},
        "prod512_cuda_dispatch": ctx512["fused"]["per_step"],
        "prod512_jax_dispatch": ctx512["sdpa"]["per_step"],
        "prod512_per_request": {k: n // PROD_REQUESTS for k, n in ctx512["serve_counts"].items()},
        "trainer_lthm_train_per_step": trainer["per_step"],
        "trainer_knobs_lthm_train_per_step": knobs["per_step"],
        "moe_prod512_per_step": moe["train"]["per_step"],
        "moe_prod512_per_request": {k: n // PROD_REQUESTS for k, n in moe["serve_counts"].items()},
        "sparse_long_history_per_step": sparse["train"]["per_step"],
        "sparse_long_history_per_request": {k: n // LONG_REQUESTS for k, n in sparse["serve_counts"].items()},
    }

    def new_paths(name):
        """Launches per step (per request) of kernel ``name`` on the paths this script added last."""
        return {path: counts[name] for path, counts in paths.items() if counts.get(name)}
    bias_kernels = {  # name: (source, the TPU kernel's def in recommendations_tpu/ops/fused_attention.py)
        "flash_bias_fwd": ("flash_fwd.cu", 578), "flash_bias_dq": ("flash_bwd.cu", 668),
        "flash_bias_dkv": ("flash_bwd.cu", 738),
    }
    bias_entries = [{
        "name": name,
        "route": "cuda",
        "source": f"recommendations_tpu_torch/ops/csrc/{src}",
        "replaces": f"recommendations_tpu/ops/fused_attention.py:{line}",
        "launches": prod_training["counts"][name],
        "launches_per_step": prod_training["counts"][name] // PROD_STEPS,
        "launches_serving": prod_serving["counts"][name],
        "launches_per_request": prod_serving["counts"][name] // PROD_REQUESTS,
        "max_abs_err": bias_errs[name][0],
        "tolerance": bias_errs[name][1],
        **({"dtable_max_abs_err": bias_errs["dtable"][0], "dtable_tolerance": bias_errs["dtable"][1]}
           if name == "flash_bias_dkv" else {}),
        **bias_times[name],
        "plain_batch": PLAIN_BATCH,
        "library_call": "scaled_dot_product_attention, float attn_mask, enable_gqa"
                        + (" (backward: dq, dk, dv and the mask gradient in one)" if name != "flash_bias_fwd" else ""),
        **({"layer_crossover_b16": crossover,
            "layer_sweep_t_eq_window": {f"b{b}_t{tl}_{'fused' if f else 'sdpa'}_ms": ms
                                        for (b, tl, f), ms in sweep.items()}} if name == "flash_bias_fwd" else {}),
        "launches_per_step_new_paths": new_paths(name),
        "knobs_max_abs_err": knobs["bias_errs"][name][0],
        "knobs_tolerance": knobs["bias_errs"][name][1],
        **({"pipeline_extras": {"launches": extras["counts"][name],
                                "per_inference_batch_and_entry_point": extras["entry_launches"],
                                "per_knn_query_batch": extras["knn_query_launches"],
                                "per_pt2_call": extras["program_launches"]}} if name == "flash_bias_fwd" else
           {"pipeline_extras": {"launches": extras["counts"][name]}}),
    } for name, (src, line) in bias_kernels.items()]
    ce_replaces = {"ce_row_diag": 82, "ce_fwd": 102, "ce_dq": 135, "ce_dc": 168}
    ce_entries = [{
        "name": name,
        "route": "cuda",
        "source": "recommendations_tpu_torch/ops/csrc/fused_ce.cu",
        "replaces": f"recommendations_tpu/ops/fused_ce.py:{line}",
        "launches": train_counts[name],
        "launches_per_step": train_counts[name] // TRAIN_STEPS,
        "max_abs_err": ce_errs[name],
        "tolerance": ce_tols[name],
        **ce_times[name],
        **({"library_call": "torch.linalg.vecdot of the bf16 rows (bf16 out, no shift: a yardstick)"}
           if name == "ce_row_diag" else {}),
        "n32768": {**ce_times_prod[name], "launches_per_step": prod_training["counts"][name] // PROD_STEPS},
        "n16384": {**ce_times_512[name], "launches_per_step": ctx512["fused"]["per_step"][name]},
        "n16384_rounded": ce_times_512_rounded[name],
        "launches_per_step_new_paths": new_paths(name),
        "knobs_max_abs_err": knobs["ce_errs"][name],
        "knobs_tolerance": knobs["ce_tols"][name],
    } for name, line in ce_replaces.items()]
    phase_took(5, t_phase)
    multi = distributed_phase(kernels, smi)
    tiny = quality["lthm_tiny"]

    def tiny_entry(name):
        """Kernel ``name`` at lthm_tiny's kernel arm: held to its plain version
        at the arm's shapes in phase [2], its launches in phase [7]."""
        return {"max_abs_err": tiny_errs[name][0], "tolerance": tiny_errs[name][1],
                "launches": sum(c[name] for tag, c in tiny["counts"].items() if tag.startswith("kernels")),
                "launches_per_step": tiny["per_step"][name],
                "launches_per_val_batch": tiny["per_val_batch"].get(name, 0)}
    for entry in ce_entries:
        entry["lthm_tiny"] = tiny_entry(entry["name"])
    for entry in (*bias_entries, *ce_entries):
        entry["launches_per_rank_step_data_parallel"] = multi["per_rank_step"][entry["name"]]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "recommendations_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "recommendations_tpu/ops/fused_attention.py:193",
        "launches": train_counts["flash_fwd"],
        "launches_per_step": train_counts["flash_fwd"] // TRAIN_STEPS,
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
        "t1025": {"ms": long_ms, "plain_ms": long_plain_ms, "bound_ms": long_bound_ms,
                  "bound_by": long_bound_by, "library_ms": long_library_ms,
                  "launches_per_request": long_json["launches_per_request"],
                  "launches_per_step": long_json["launches_per_step"]["flash_fwd"]},
        "long_history": long_json,
        "t512_sparse": {**s512, "launches_per_request": sparse["serve_counts"]["flash_fwd"] // LONG_REQUESTS,
                        "launches_per_step": sparse["train"]["per_step"]["flash_fwd"]},
        "launches_per_step_new_paths": new_paths("flash_fwd"),
        "lthm_tiny": tiny_entry("flash_fwd"),
    }, {
        "name": "flash_bwd",
        "route": "cuda",
        "source": "recommendations_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "recommendations_tpu/ops/fused_attention.py:442",
        "launches": train_counts["flash_bwd"],
        "launches_per_step": train_counts["flash_bwd"] // TRAIN_STEPS,
        "max_abs_err": bwd_err,
        "tolerance": bwd_tol,
        **bwd_times,
        "t450": bwd_t450,
        "t1025": {**bwd_t1025, "launches_per_step": long_json["launches_per_step"]["flash_bwd"]},
        "t512_sparse": {**bwd_t512, "launches_per_step": sparse["train"]["per_step"]["flash_bwd"]},
        "launches_per_step_new_paths": new_paths("flash_bwd"),
        "lthm_tiny": tiny_entry("flash_bwd"),
    }, *bias_entries, *ce_entries]}))
    print(f"[5] chip_smoke.py took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--phase6-rank":
        sys.exit(phase6_rank(sys.argv[2:]))
    sys.exit(main())
