"""The no-bias flash kernels (and the bias kernels beside them) of two source
trees on one NVIDIA GPU: this checkout's ``recommendations_tpu_torch/ops/csrc``
and another copy of the same files (for example a parent commit's), each
checked against its plain version and timed in turns (other, this, this,
other) with ``scaled_dot_product_attention`` in the same process.

    python3 tools/probe_flash.py --other traces/parent_csrc        # check and time
    python3 tools/probe_flash.py --other traces/parent_csrc --check-only
    python3 tools/probe_flash.py --other traces/parent_csrc --rounding 6   # bf16 rounding agreement

``--other`` holds ``flash_fwd.cu``, ``flash_bwd.cu`` and ``flash_bias.cuh``
(``git show <commit>:recommendations_tpu_torch/ops/csrc/<file>``). Prints
nvcc's register and spill lines for both, one line per measurement, the
backward's two kernels apart (``torch.profiler``, device time by kernel
name), and a JSON summary as its last line. Shapes: MQA 32x16, bf16,
causal; the forward at B=16, T=1025 and B=64, T=257; the backward at those
and B=32, T=450; the bias kernels at the production shape B=64, T=1025,
nk=1025, the bias forward also at B=16 (the bias forward and the bias dQ
kernel checked first at B=16 against their plain versions, each tree at its
own arithmetic: this tree's at ``bias_kernel_softmax``'s; a tree without
the one-pass bias forward at the two-pass kernel's staged tile and exp, and
one without the tensor-core bias dQ kernel at exp in dQ, as its source
says; both printed beside their exponential floor). This
checkout's ``flash_bias_dkv`` is also timed as a build with
its table gradient cut out (``DTABLE = false`` in the kernel's source): its
time beside the full kernel's is what the table gradient costs; and its
``flash_bias_fwd`` as builds with the bias staged but not added (the bias
load in ``mqa_tc_bias_fwd_kernel`` rewritten to zeros) and neither staged
nor added (the calls that stage and convert the table rows also taken out):
what the bias read and the bias staging cost. The cut builds land in
``traces/probe_*/`` (gitignored) and compute something else: they are
timed, never checked.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recommendations_tpu_torch.ops import fused_attention as fa  # noqa: E402
from recommendations_tpu_torch.ops.cuda_build import CudaKernel  # noqa: E402

H, HD = 32, 16
FWD_SHAPES = ((16, 1025), (64, 257))
BWD_SHAPES = ((16, 1025), (32, 450), (64, 257))
BIAS_SHAPE = (64, 1025)
BIAS_FWD_BATCHES = (64, 16)  # the bias forward at T = 1025
# one exponential per live (row, head, key) at 16 a clock per SM, 132 SMs, 1.98 GHz
EXP_PER_S = 16 * 132 * 1.98e9


def kernels_of(csrc: Path | None) -> dict:
    """The five flash entries (and the slice-count query) of a source tree;
    None is this checkout's. The query took a ``causal`` argument before
    the persistent bias dK/dV grid: its arity is read from the source."""
    if csrc is None:
        return {k.symbol: k for k in (*fa.KERNELS, fa._BIAS_DKV_SLICES)}
    out = {}
    for k in (*fa.KERNELS, fa._BIAS_DKV_SLICES):
        other = CudaKernel(k.source.name, k.symbol, k.argtypes)
        other.source = csrc / k.source.name
        if k is fa._BIAS_DKV_SLICES:
            params = re.search(r"int flash_bias_dkv_slices\(([^)]*)\)", other.source.read_text()).group(1)
            other.argtypes = [ctypes.c_int] * len(params.split(","))
        out[k.symbol] = other
    return out


def slices_of(kerns, b, t) -> int:
    """The table-gradient slices of the tree's flash_bias_dkv at MQA H x HD,
    bf16 (a ``causal`` argument, where the query has one, is 1)."""
    query = kerns["flash_bias_dkv_slices"]
    return query.build()(b, t, H, 1, HD, *[1] * (len(query.argtypes) - 5))


# the cuts, as (pattern, replacement) rewrites of one source, each of which
# must match exactly once
NO_DTABLE = [(re.escape("constexpr bool DTABLE = true;"), "constexpr bool DTABLE = false;")]
BIAS_STAGED_ONLY = [(re.escape("const uint2 bb = bp[4 * nt];"), "const uint2 bb = make_uint2(0u, 0u);")]
NO_BIAS_WORK = BIAS_STAGED_ONLY + [(r"tc_bias_stage_rows\([^;]*\);", ""), (r"tc_bias_convert\([^;]*\);", "")]


def cut_build(csrc: Path, out: Path, source: str, cuts: list) -> Path:
    """A copy of the tree with ``source`` rewritten by ``cuts`` (for timing
    only: the copy computes something else)."""
    src = (csrc / source).read_text()
    for pattern, repl in cuts:
        src, n = re.subn(pattern, repl, src)
        if n != 1:
            raise RuntimeError(f"{csrc}/{source}: `{pattern}` matches {n} times, not once")
    out.mkdir(parents=True, exist_ok=True)
    for f in (*csrc.glob("*.cu"), *csrc.glob("*.cuh")):
        (out / f.name).write_text(f.read_text())
    (out / source).write_text(src)
    return out


def registers(kern) -> list:
    lines, entry = [], ""
    for line in kern.build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            base = re.search(r"[a-z_]*kernel[a-z_]*", mangled)
            entry = (base.group(0) if base else mangled) + "<" + ",".join(re.findall(r"L[ib](\d+)E", mangled)) + ">"
        elif "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
            lines.append(f"{kern.source.name} {entry}: " + line.split(":", 1)[-1].strip())
    return lines


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


def qkv(b, t, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, t, H * HD, generator=g, device="cuda").bfloat16()
    k = torch.randn(b, t, HD, generator=g, device="cuda").bfloat16()
    v = torch.randn(b, t, HD, generator=g, device="cuda").bfloat16()
    do = torch.randn(b, t, H * HD, generator=g, device="cuda").bfloat16()
    return q, k, v, do


class Entries:
    """Launchers of one tree's entries on fixed inputs."""

    def __init__(self, kerns):
        self.k = kerns
        self.stream = torch.cuda.current_stream().cuda_stream

    def fwd(self, q, k, v, o, lse, b, t):
        return lambda: self.k["flash_fwd"].launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, t, H, 1, HD, 1, 1, self.stream)

    def bwd(self, q, k, v, do, lse, dcol, dq, dk, dv, b, t):
        return lambda: self.k["flash_bwd"].launch(
            *(x.data_ptr() for x in (q, k, v, do, lse, dcol, dq, dk, dv)), b, t, H, 1, HD, 1, 1, self.stream)


def check(name, kerns, b, t, arith=None):
    """The tree's forward and backward against the plain versions (the
    forward at its kernel's softmax arithmetic), plain over 4 rows at a time;
    the backward twice for the same bits. ``arith``: the forward's softmax
    arithmetic when it is not this checkout's."""
    e = Entries(kerns)
    q, k, v, do = qkv(b, t, seed=b + t)
    o, lse = torch.empty_like(q), torch.empty(b, t, H, device="cuda")
    e.fwd(q, k, v, o, lse, b, t)()
    dcol = fa._rowsum_do_o(do, o, H).contiguous()
    grads = [torch.empty_like(x) for x in (q, k, v)]
    again = [torch.empty_like(x) for x in (q, k, v)]
    e.bwd(q, k, v, do, lse, dcol, *grads, b, t)()
    e.bwd(q, k, v, do, lse, dcol, *again, b, t)()
    torch.cuda.synchronize()
    arith = arith or fa.kernel_softmax(q, k, H)
    o_err = l_err = 0.0
    g_err = [0.0, 0.0, 0.0]
    want_g = []
    for i in range(0, b, 4):
        r = slice(i, i + 4)
        ro, rl = fa.fused_flash_attention_reference(q[r], k[r], v[r], H, True, **arith)
        o_err = max(o_err, (o[r].float() - ro.float()).abs().max().item())
        l_err = max(l_err, (lse[r] - rl).abs().max().item())
        want_g.append(fa.fused_flash_attention_bwd_reference(
            q[r], k[r], v[r], o[r], lse[r], do[r], H, True, exp2=arith["exp2"]))
    want = [torch.cat([w[j] for w in want_g]) for j in range(3)]
    top = [max(1.0, w.float().abs().max().item()) for w in want]
    g_err = [(g.float() - w.float()).abs().max().item() for g, w in zip(grads, want)]
    same = all(torch.equal(x, y) for x, y in zip(grads, again))
    o_tol = 2**-8 * max(1.0, o.float().abs().max().item())
    ok = o_err <= o_tol and l_err <= 1e-4 and all(er <= 2**-8 * tp for er, tp in zip(g_err, top)) and same
    print(f"[check] {name} B={b} T={t}: o {o_err:.3e} (tol {o_tol:.3e}), lse {l_err:.3e} (tol 1e-4), "
          f"dq {g_err[0]:.3e} dk {g_err[1]:.3e} dv {g_err[2]:.3e} (tol 2^-8 of the largest: "
          f"{', '.join(f'{2**-8 * tp:.3e}' for tp in top)}), same bits twice {same} -> {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def check_bias_fwd(name, kerns, b, t, arith):
    """The tree's bias forward against the plain version at ``arith`` (the
    tree's softmax arithmetic), plain over 4 rows at a time, twice for the
    same bits."""
    q, k, v, _ = qkv(b, t, seed=b + t + 1)
    table = torch.randn(2 * t + 1, H, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    outs = []
    for _ in range(2):
        o, lse = torch.empty_like(q), torch.empty(b, t, H, device="cuda")
        kerns["flash_bias_fwd"].launch(*(x.data_ptr() for x in (q, k, v, table, o, lse)), b, t, H, 1, HD,
                                       table.shape[0], t, 1, 1, torch.cuda.current_stream().cuda_stream)
        outs.append((o, lse))
    torch.cuda.synchronize()
    (o, lse), again = outs
    parts = [fa.fused_flash_attention_bias_reference(q[i:i + 4], k[i:i + 4], v[i:i + 4], table, H, t, True, **arith)
             for i in range(0, b, 4)]
    ro, rl = torch.cat([x[0] for x in parts]), torch.cat([x[1] for x in parts])
    o_err, l_err = (o.float() - ro.float()).abs().max().item(), (lse - rl).abs().max().item()
    same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
    o_tol = 2**-8 * max(1.0, ro.float().abs().max().item())
    ok = o_err <= o_tol and l_err <= 1e-4 and same
    print(f"[check] {name} flash_bias_fwd B={b} T={t} nk={t} (plain at chunk {arith['chunk']}, "
          f"{'exp2' if arith['exp2'] else 'exp'}): o {o_err:.3e} (tol {o_tol:.3e}), lse {l_err:.3e} (tol 1e-4), "
          f"same bits twice {same} -> {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def check_bias_dq(name, kerns, b, t, exp2):
    """The tree's bias dQ against the plain backward's dq with p taken as
    ``exp2`` says (the tree's arithmetic), plain over 4 rows at a time,
    within one bf16 ulp of the largest element; twice for the same bits."""
    q, k, v, do = qkv(b, t, seed=b + t + 2)
    table = torch.randn(2 * t + 1, H, generator=torch.Generator(device="cuda").manual_seed(6), device="cuda")
    o, lse = fa.fused_flash_attention_bias_fwd(q, k, v, table, H, t, True)
    dcol = fa._rowsum_do_o(do, o, H).contiguous()
    outs = [torch.empty_like(q), torch.empty_like(q)]
    for dq in outs:
        kerns["flash_bias_dq"].launch(*(x.data_ptr() for x in (q, k, v, do, lse, dcol, table, dq)), b, t, H, 1, HD,
                                      table.shape[0], t, 1, 1, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    want = torch.cat([fa.fused_flash_attention_bias_bwd_reference(
        q[i:i + 4], k[i:i + 4], v[i:i + 4], table, o[i:i + 4], lse[i:i + 4], do[i:i + 4], H, t, True,
        exp2=exp2)[0] for i in range(0, b, 4)])
    err = (outs[0].float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    tol = 2.0 ** (math.floor(math.log2(top)) - 7)
    same = torch.equal(outs[0], outs[1])
    ok = err <= tol and same
    print(f"[check] {name} flash_bias_dq B={b} T={t} nk={t} (plain at {'exp2' if exp2 else 'exp'}): dq {err:.3e} "
          f"(tol one bf16 ulp of the largest, {tol:.3e}), same bits twice {same} -> {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def rounding(trees, seeds):
    """How often each tree's backward lands on another bf16 value than its
    plain version (at the tree's own arithmetic: exp for the other tree,
    exp2 for this one), over ``seeds`` inputs at each of six shapes: the
    share of output elements that differ, and the runs where an element
    differs by more than 2^-8 of the largest (chip_smoke's tolerance, under
    one bf16 ulp when the largest lies just above a power of two)."""
    shapes = ((2, 300, 16, 64, False), (32, 450, 32, 16, True), (16, 1025, 32, 16, True),
              (64, 257, 32, 16, True), (4, 257, 32, 16, False), (2, 1100, 32, 16, True))
    stats = {n: [0, 0, 0.0] for n in trees}
    for b, t, h, hd, causal in shapes:
        for seed in range(seeds):
            g = torch.Generator(device="cuda").manual_seed(100 + seed)
            q = torch.randn(b, t, h * hd, generator=g, device="cuda").bfloat16()
            k, v = (torch.randn(b, t, hd, generator=g, device="cuda").bfloat16() for _ in range(2))
            do = torch.randn(b, t, h * hd, generator=g, device="cuda").bfloat16()
            o, lse = fa.fused_flash_attention_fwd(q, k, v, h, causal)
            dcol = fa._rowsum_do_o(do, o, h).contiguous()
            for name, kerns in trees.items():
                exp2 = name == "this"
                parts = [fa.fused_flash_attention_bwd_reference(
                    q[i:i + 4], k[i:i + 4], v[i:i + 4], o[i:i + 4], lse[i:i + 4], do[i:i + 4], h, causal, exp2=exp2)
                    for i in range(0, b, 4)]
                got = [torch.empty_like(x) for x in (q, k, v)]
                kerns["flash_bwd"].launch(*(x.data_ptr() for x in (q, k, v, do, lse, dcol, *got)), b, t, h, 1, hd,
                                          int(causal), 1, torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                fail, differ, total = False, 0, 0
                for j, gv in enumerate(got):
                    w = torch.cat([x[j] for x in parts])
                    err = (gv.float() - w.float()).abs()
                    fail |= bool((err > 2**-8 * max(1.0, w.float().abs().max().item())).any())
                    differ, total = differ + int((err > 0).sum()), total + err.numel()
                stats[name][0] += fail
                stats[name][1] += 1
                stats[name][2] += differ / total
    for name, (fails, runs, share) in stats.items():
        print(f"[rounding] {name}: {fails} of {runs} runs with an element past 2^-8 of the largest; "
              f"mean share of output elements on another bf16 value {share / runs:.3e}", flush=True)


def split_bwd(bwd, iters=10):
    """Device time per call of each kernel the backward entry launches."""
    from torch.profiler import ProfilerActivity, profile

    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            bwd()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if "kernel" in ev.key:
            name = re.search(r"[a-z_]*kernel[a-z_]*", ev.key).group(0)
            dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            out[name] = out.get(name, 0.0) + dev_us / 1e3 / iters
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="a directory with flash_fwd.cu, flash_bwd.cu, flash_bias.cuh")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--rounding", type=int, default=0, metavar="SEEDS",
                    help="only count the backward's rounding differences over SEEDS inputs a shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_flash: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products in full f32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    trees = {"other": kernels_of(Path(args.other)), "this": kernels_of(None)}
    if not (args.check_only or args.rounding):
        csrc, split = Path(fa.FLASH_BWD.source).parent, Path(__file__).resolve().parent.parent / "traces"
        cut = cut_build(csrc, split / "probe_split", "flash_bwd.cu", NO_DTABLE)
        trees["this_no_dtable"] = {k: v for k, v in kernels_of(cut).items() if k.startswith("flash_bias_dkv")}
        for cuts, label in ((BIAS_STAGED_ONLY, "this_bias_staged_only"), (NO_BIAS_WORK, "this_no_bias_work")):
            cut = cut_build(csrc, split / f"probe_{label}", "flash_fwd.cu", cuts)
            trees[label] = {"flash_bias_fwd": kernels_of(cut)["flash_bias_fwd"]}
    builds = [kern for kerns in trees.values() for kern in kerns.values()]
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda kern: kern.build(), builds))
    for name, kerns in trees.items():
        seen = set()
        for kern in kerns.values():
            if kern.source not in seen:
                seen.add(kern.source)
                for line in registers(kern):
                    print(f"[ptxas] {name} {line}", flush=True)

    if args.rounding:
        rounding(trees, args.rounding)
        return 0
    ok = True
    for b, t in ((2, 1), (2, 70), (3, 1025), (2, 1026), (16, 1025), (32, 450), (64, 257)):
        for name in ("this", "other") if (b, t) == (16, 1025) else ("this",):
            ok &= check(name, trees[name], b, t, None if name == "this" else {"chunk": 512, "exp2": False})
    q, k, _, _ = qkv(1, BIAS_SHAPE[1], seed=0)
    ok &= check_bias_fwd("this", trees["this"], 16, BIAS_SHAPE[1], fa.bias_kernel_softmax(q, k, H))
    # the other tree at its own arithmetic, read from its source: a tree
    # without the tensor-core bias kernels takes the two-pass forward's
    # staged tile and exp, and exp in the dQ kernel
    other_src = Path(args.other)
    one_pass = "mqa_tc_bias_fwd_kernel" in (other_src / "flash_fwd.cu").read_text()
    tc_dq = "mqa_tc_bias_dq_kernel" in (other_src / "flash_bwd.cu").read_text()
    ok &= check_bias_fwd("other", trees["other"], 16, BIAS_SHAPE[1],
                         fa.bias_kernel_softmax(q, k, H) if one_pass else
                         {"chunk": fa._mma_bias_tile(BIAS_SHAPE[1], H, HD), "exp2": False})
    for name in ("this", "other"):
        ok &= check_bias_dq(name, trees[name], 16, BIAS_SHAPE[1], name == "this" or tc_dq)
    if args.check_only or not ok:
        print(json.dumps({"ok": ok}))
        return 0 if ok else 1

    res = {"device": smi, "fwd": {}, "bwd": {}, "bias": {}}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, t in FWD_SHAPES:
        q, k, v, _ = qkv(b, t, seed=1)
        o, lse = torch.empty_like(q), torch.empty(b, t, H, device="cuda")
        fns = {n: Entries(trees[n]).fwd(q, k, v, o, lse, b, t) for n in ("other", "this")}
        times = {n: [] for n in fns}
        for n in ("other", "this", "this", "other"):
            times[n].append(cuda_ms(fns[n], 30))
        qh = q.view(b, t, H, HD).transpose(1, 2)
        kh = k.view(b, t, 1, HD).transpose(1, 2).expand(b, H, t, HD)
        vh = v.view(b, t, 1, HD).transpose(1, 2).expand(b, H, t, HD)
        lib = cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=True), 30)
        res["fwd"][f"B{b}_T{t}"] = {**times, "sdpa": lib}
        print(f"[time] flash_fwd B={b} T={t}: other {times['other']} ms, this {times['this']} ms, "
              f"scaled_dot_product_attention {lib:.4f} ms", flush=True)
    for b, t in BWD_SHAPES:
        q, k, v, do = qkv(b, t, seed=2)
        o, lse = torch.empty_like(q), torch.empty(b, t, H, device="cuda")
        Entries(trees["this"]).fwd(q, k, v, o, lse, b, t)()
        dcol = fa._rowsum_do_o(do, o, H).contiguous()
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        fns = {n: Entries(trees[n]).bwd(q, k, v, do, lse, dcol, dq, dk, dv, b, t) for n in ("other", "this")}
        times = {n: [] for n in fns}
        for n in ("other", "this", "this", "other"):
            times[n].append(cuda_ms(fns[n], 20))
        split = {n: split_bwd(fn) for n, fn in fns.items()}
        qh = q.view(b, t, H, HD).transpose(1, 2).detach().requires_grad_()
        kh = k.view(b, t, 1, HD).transpose(1, 2).detach().requires_grad_()
        vh = v.view(b, t, 1, HD).transpose(1, 2).detach().requires_grad_()
        doh = do.view(b, t, H, HD).transpose(1, 2)

        def sdpa_fwd():
            with torch.no_grad():
                sdpa(qh, kh.expand(b, H, t, HD), vh.expand(b, H, t, HD), is_causal=True)

        def sdpa_fwd_bwd():
            out = sdpa(qh, kh.expand(b, H, t, HD), vh.expand(b, H, t, HD), is_causal=True)
            torch.autograd.grad(out, (qh, kh, vh), doh)

        lib = cuda_ms(sdpa_fwd_bwd, 20) - cuda_ms(sdpa_fwd, 20)
        res["bwd"][f"B{b}_T{t}"] = {**times, "sdpa_backward": lib, "split": split}
        print(f"[time] flash_bwd B={b} T={t}: other {times['other']} ms, this {times['this']} ms, "
              f"scaled_dot_product_attention backward {lib:.4f} ms; by kernel (profiler, ms a call) {split}",
              flush=True)

    t = BIAS_SHAPE[1]
    nk = t
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda *xs: [x.data_ptr() for x in xs]  # noqa: E731
    table = torch.randn(2 * nk + 1, H, generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")
    for b in BIAS_FWD_BATCHES:
        q, k, v, _ = qkv(b, t, seed=3)
        o2, lse2 = torch.empty_like(q), torch.empty(b, t, H, device="cuda")
        common = (b, t, H, 1, HD, table.shape[0], nk, 1, 1, stream)
        fns = {n: (lambda kern: lambda: kern.launch(*ptr(q, k, v, table, o2, lse2), *common))(kerns["flash_bias_fwd"])
               for n, kerns in trees.items() if "flash_bias_fwd" in kerns}
        times = {n: [] for n in fns}
        order = ("other", "this", "this", "other")
        if "this_no_bias_work" in fns:  # the bias's cost, in turns beside the full kernel
            order = ("other", "this", "this_bias_staged_only", "this_no_bias_work", "this_no_bias_work",
                     "this_bias_staged_only", "this", "other")
        for n in order:
            times[n].append(cuda_ms(fns[n], 10))
        floor = b * H * t * (t + 1) // 2 / EXP_PER_S * 1e3
        res["bias"][f"flash_bias_fwd_B{b}"] = {**times, "exp_floor_ms": floor}
        print(f"[time] flash_bias_fwd B={b} T={t} nk={nk}: " + ", ".join(f"{n} {v} ms" for n, v in times.items())
              + f"; exponential floor {floor:.4f} ms (this at {min(times['this']) / floor:.2f}x it)", flush=True)

    b = BIAS_SHAPE[0]
    q, k, v, do = qkv(b, t, seed=3)
    o, lse = fa.fused_flash_attention_bias_fwd(q, k, v, table, H, nk, True)
    dcol = fa._rowsum_do_o(do, o, H).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (b, t, H, 1, HD, table.shape[0], nk, 1, 1, stream)
    for kname in ("flash_bias_dq", "flash_bias_dkv"):
        fns = {}
        for n, kerns in trees.items():
            if kname not in kerns:
                continue
            part = torch.zeros((slices_of(kerns, b, t), table.shape[0], H), device="cuda")
            args = {"flash_bias_dq": ptr(q, k, v, do, lse, dcol, table, dq),
                    "flash_bias_dkv": ptr(q, k, v, do, lse, dcol, table, dk, dv, part)}[kname]
            fns[n] = (lambda kern, a, p: lambda: (p, kern.launch(*a, *common)))(kerns[kname], args, part)
        times = {n: [] for n in fns}
        order = ("other", "this", "this", "other")
        if "this_no_dtable" in fns:  # the table gradient's share, in turns beside the full kernel
            order = ("other", "this", "this_no_dtable", "this_no_dtable", "this", "other")
        for n in order:
            times[n].append(cuda_ms(fns[n], 10))
        floor = b * H * t * (t + 1) // 2 / EXP_PER_S * 1e3
        res["bias"][kname] = {**times, "exp_floor_ms": floor}
        print(f"[time] {kname} B={b} T={t} nk={nk}: " + ", ".join(f"{n} {v} ms" for n, v in times.items())
              + f"; exponential floor {floor:.4f} ms (this at {min(times['this']) / floor:.2f}x it)", flush=True)
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
