"""The fused contrastive-CE kernels alone on the card, and beside another
copy of their source.

    python3 tools/probe_fused_ce.py                                   # this checkout
    python3 tools/probe_fused_ce.py --other traces/parent_csrc        # and in turns with another tree
    python3 tools/probe_fused_ce.py --other traces/parent_csrc --check-only

Builds ``recommendations_tpu_torch/ops/csrc/fused_ce.cu`` (printing what
``ptxas`` reports for each kernel), runs the forward and backward wrappers at
five shapes against their plain versions (ce error relative to 1 + |ce|, the
rows whose rank differs, dq and dc errors over their largest element,
``ce_row_diag``'s diag error and whether its shift m has the plain shift's
bits, two runs for the same bits), then times each kernel alone
(``ce_row_diag``, ``ce_fwd``, ``ce_dq``, ``ce_dc``) with its inputs ready at
LTHM-base's loss
chunk (N = 8192, s = 256) and the production chunk (N = 32768, s = 1024),
D = 128. ``--other`` holds another ``fused_ce.cu`` (``git show
<commit>:recommendations_tpu_torch/ops/csrc/fused_ce.cu``): its kernels are
checked the same way and timed in turns with this tree's (other, this, this,
other) in the same process, ``ce_dq`` and ``ce_dc`` with the rate of their
two products, ``ce_fwd`` beside its exponential floor, ``ce_row_diag`` also
by its device time under the profiler (a loop of its launches is
host-bound) beside ``torch.linalg.vecdot``'s. A tree whose
``ce_row_diag`` entry takes no ``lq`` (before the shift moved into it; its
arity is read from the source) is bound with its own signature and timed
with the four operations that formed the shift before it, the work the new
launch replaces. This tree's ``ce_fwd`` and ``ce_row_diag`` are also timed
as cut builds (in ``traces/probe_ce_*/``, gitignored): ``ce_fwd_tc_kernel``'s
source rewritten to the products without the sums, the sums without the
products, neither; ``row_diag_kernel``'s to the rows without the shift
block's work, and the shift block alone. They compute something else and
are timed, never checked: what the sums and the products cost beside the
staging, and whether the shift block is the launch's tail. Needs a card;
imports nothing of JAX. The last line is a JSON summary. ``chip_smoke.py``
holds the same kernels to stated tolerances and times each alone.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((8192, 256, 128, 0.0), (100, 10, 16, 1.0), (8448, 264, 64, 1.0), (512, 32, 32, 0.5), (32768, 1024, 128, 0.0))
TIMED = ((8192, 256), (32768, 1024))  # (N, s) at D = 128
# the cuts, rewrites of one kernel's body (the text after its marker): in
# ce_fwd_tc_kernel the wgmma that issues S and the call that forms a stage's
# sums and ranks; in row_diag_kernel the shift block's work and the rows'
FWD_KERNEL = "ce_fwd_tc_kernel(const __grid_constant__"
NO_PRODUCTS = (r"wgmma_ss<SR>\([^;]*\);", "")
NO_SUMS = (r"sums\(st, k & 1, cur\);", "")
ROW_DIAG_KERNEL = "row_diag_kernel(const bf16* __restrict__ q"
NO_SHIFT = (r"lq_shift\(lq, m, n, inv_t, beta\);", "")
NO_ROWS = (re.escape("for (int base = 0;"), "for (int base = n;")
CUTS = {  # label: (kernel timed, its marker, the rewrites)
    "this_products_only": ("ce_fwd", FWD_KERNEL, [NO_SUMS]),
    "this_sums_only": ("ce_fwd", FWD_KERNEL, [NO_PRODUCTS]),
    "this_neither": ("ce_fwd", FWD_KERNEL, [NO_PRODUCTS, NO_SUMS]),
    "this_rows_only": ("ce_row_diag", ROW_DIAG_KERNEL, [NO_SHIFT]),
    "this_shift_only": ("ce_row_diag", ROW_DIAG_KERNEL, [NO_ROWS]),
}
# ce_row_diag's entry before the shift moved into it: (q, c, v, diag, n, d, inv_t, stream)
SHIFT_APART = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
INV_T = 20.0


def cut_kernel(src: str, marker: str, cuts) -> str:
    """``src`` with each of ``cuts`` made once in the body after ``marker``
    (for timing only: the copy computes something else)."""
    if src.count(marker) != 1:
        raise RuntimeError(f"no `{marker}` to cut")
    head, body = src.split(marker)
    for pattern, repl in cuts:
        body, n = re.subn(pattern, repl, body, count=1)
        if n != 1:
            raise RuntimeError(f"{marker}: no `{pattern}` to cut")
    return head + marker + body


def row_diag_argtypes(source: Path, default: list) -> list:
    """The argtypes of ``source``'s ce_row_diag entry: ``default`` (this
    tree's) or, where the entry takes 8 arguments, ``SHIFT_APART``."""
    params = re.search(r'extern "C" int ce_row_diag\(([^)]*)\)', source.read_text()).group(1)
    return SHIFT_APART if len(params.split(",")) == len(SHIFT_APART) else default


def row_diag_and_shift(kern, q, c, v, lq, diag, m, n, d, inv_t, beta, stream):
    """One ce_forward's row diagonal and shift with ``kern``: one launch that
    writes diag and m; or, for an entry that takes no lq, the four
    operations that formed m before it (abs, amax, mul, add; the returned m)
    and its launch."""
    if kern.argtypes == SHIFT_APART:
        m = lq.abs().amax().mul(beta).add(inv_t + 1.0)
        kern.launch(q.data_ptr(), c.data_ptr(), v.data_ptr(), diag.data_ptr(), n, d, inv_t, stream)
        return m
    kern.launch(q.data_ptr(), c.data_ptr(), v.data_ptr(), lq.data_ptr(), diag.data_ptr(), m.data_ptr(),
                n, d, inv_t, beta, stream)
    return m


def ce_forward_shift_apart(q16, c16, v, lq, s, inv_t, beta, round_logits=False):
    """``fused_ce.ce_forward`` for a tree whose ce_row_diag takes no lq (bound
    with ``SHIFT_APART``): the shift's four operations, then the two launches.
    Such a tree has no rounded case."""
    import torch

    from recommendations_tpu_torch.ops import fused_ce as f

    if round_logits:
        raise ValueError("a tree whose ce_row_diag takes no lq has no rounded case")
    f._check(q16, c16, v, lq)
    f._check_launch(q16, c16, v, lq, s)
    n, d = q16.shape
    diag = torch.empty(n, dtype=torch.float32, device=q16.device)
    ce, lse = torch.empty_like(diag), torch.empty_like(diag)
    rank = torch.empty(n, dtype=torch.int32, device=q16.device)
    stream = torch.cuda.current_stream(q16.device).cuda_stream
    m = row_diag_and_shift(f.CE_ROW_DIAG, q16, c16, v, lq, diag, None, n, d, inv_t, beta, stream)
    f.CE_FWD.launch(
        q16.data_ptr(), c16.data_ptr(), v.data_ptr(), lq.data_ptr(), m.data_ptr(), diag.data_ptr(),
        ce.data_ptr(), lse.data_ptr(), rank.data_ptr(), n, d, s, inv_t, beta, stream,
    )
    return ce, rank, lse


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="a directory with another fused_ce.cu")
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_fused_ce: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' f32 products in full f32
    from recommendations_tpu_torch.ops import fused_ce as f
    from recommendations_tpu_torch.ops.cuda_build import CudaKernel

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    def kernels_at(source: Path) -> dict:
        out = {}
        for k in f.KERNELS:
            o = CudaKernel(k.source.name, k.symbol, k.argtypes)
            o.source = source
            out[k.symbol] = o
        out["ce_row_diag"].argtypes = row_diag_argtypes(source, f.CE_ROW_DIAG.argtypes)
        return out

    trees = {"this": {k.symbol: k for k in f.KERNELS}}
    if args.other:
        trees["other"] = kernels_at(Path(args.other) / "fused_ce.cu")
    # this tree's ce_fwd and ce_row_diag as cut builds, timed only
    cuts = {}
    if not args.check_only:
        src = f.CE_FWD.source.read_text()
        for label, (_, marker, cut) in CUTS.items():
            d = Path(ROOT) / "traces" / f"probe_ce_{label}"
            d.mkdir(parents=True, exist_ok=True)
            (d / "fused_ce.cu").write_text(cut_kernel(src, marker, cut))
            cuts[label] = kernels_at(d / "fused_ce.cu")
    t0 = time.time()
    with ThreadPoolExecutor(1 + len(trees) + len(cuts)) as pool:
        list(pool.map(lambda k: k.build(), [k for kerns in (*trees.values(), *cuts.values()) for k in kerns.values()]))
    print("built in", time.time() - t0)
    for name, kerns in trees.items():
        for line in kerns["ce_fwd"].build_log.splitlines():
            if any(w in line for w in ("Used ", "spill", "error", "arning", "Compiling")):
                print(f"  [{name}]", line.strip())

    def inputs(n, d, seed=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.nn.functional.normalize(torch.randn(n, d, generator=g, device="cuda"), dim=-1).bfloat16()
        c = torch.nn.functional.normalize(torch.randn(n, d, generator=g, device="cuda"), dim=-1).bfloat16()
        v = torch.rand(n, generator=g, device="cuda") > 0.1
        lq = -torch.rand(n, generator=g, device="cuda") * 10
        return q, c, v, lq

    stream = torch.cuda.current_stream().cuda_stream

    def launchers(kerns, q, c, v, lq, m, diag, lse, dce, outs, n, d, s, beta):
        ce, lse_out, rank, dq, dc, diag_out, m_out = outs
        p = (q.data_ptr(), c.data_ptr(), v.data_ptr(), lq.data_ptr())
        return {
            "ce_row_diag": lambda: row_diag_and_shift(kerns["ce_row_diag"], q, c, v, lq, diag_out, m_out, n, d,
                                                      INV_T, beta, stream),
            "ce_fwd": lambda: kerns["ce_fwd"].launch(*p, m.data_ptr(), diag.data_ptr(), ce.data_ptr(),
                                                     lse_out.data_ptr(), rank.data_ptr(), n, d, s, INV_T, beta, stream),
            "ce_dq": lambda: kerns["ce_dq"].launch(*p, lse.data_ptr(), dce.data_ptr(), dq.data_ptr(), n, d, s, INV_T,
                                                   beta, stream),
            "ce_dc": lambda: kerns["ce_dc"].launch(*p, lse.data_ptr(), dce.data_ptr(), dc.data_ptr(), n, d, s, INV_T,
                                                   beta, stream),
        }

    def empty_outs(n, d):
        e = torch.empty(n, device="cuda")
        return (e, torch.empty_like(e), torch.empty(n, dtype=torch.int32, device="cuda"),
                torch.empty(n, d, dtype=torch.bfloat16, device="cuda"),
                torch.empty(n, d, dtype=torch.bfloat16, device="cuda"),
                torch.empty_like(e), torch.empty((), device="cuda"))

    ok = True
    for n, s, d, beta in SHAPES:
        q, c, v, lq = inputs(n, d)
        rce, rrank, rlse = f.ce_forward_reference(q, c, v, lq, s, INV_T, beta)
        dce = torch.rand(n, device="cuda") * v
        rdq, rdc = f.ce_backward_reference(q, c, v, lq, rlse, dce, s, INV_T, beta)
        diag, m = f.row_diag_and_shift_reference(q, c, v, lq, INV_T, beta)
        for name, kerns in trees.items():
            outs, again, m_runs = empty_outs(n, d), empty_outs(n, d), []
            for o in (outs, again):
                fns = launchers(kerns, q, c, v, lq, m, diag, rlse, dce, o, n, d, s, beta)
                for k in ("ce_fwd", "ce_dq", "ce_dc"):
                    fns[k]()
                m_runs.append(fns["ce_row_diag"]())
            torch.cuda.synchronize()
            m_k = m_runs[0]
            ce, lse, rank, dq, dc, diag_k, _ = outs
            fin = torch.isfinite(rce)
            err = ((ce - rce).abs() / (1 + rce.abs()))[fin].max().item()
            ediag = ((diag_k - diag).abs() / (1 + diag.abs())).max().item()
            m_bits = torch.equal(m_k.view(torch.int32), m.view(torch.int32))
            nrank = (rank != rrank).sum().item()
            edq = (dq.float() - rdq.float()).abs().max().item() / rdq.float().abs().max().item()
            edc = (dc.float() - rdc.float()).abs().max().item() / rdc.float().abs().max().item()
            det = all(torch.equal(x, y) for x, y in zip((*outs[:6], m_runs[0]), (*again[:6], m_runs[1])))
            fine = bool(torch.isfinite(dq.float()).all() and torch.isfinite(dc.float()).all())
            ok &= det and fine and edq <= 2**-7 and edc <= 2**-7 and err <= 2e-5 and ediag <= 2e-5
            ok &= m_bits or name != "this"  # a tree that forms m apart keeps the order it had
            print(f"[check] {name} n={n} s={s} d={d} beta={beta}: ce rel err {err:.3e}, diag rel err {ediag:.3e}, "
                  f"m {m_k.item()!r} (plain {m.item()!r}, bit-equal {m_bits}), rank differs on {nrank} "
                  f"rows, dq err/max {edq:.3e}, dc err/max {edc:.3e}, deterministic {det}, finite {fine}", flush=True)
        del rce, rrank, rlse, rdq, rdc
        torch.cuda.empty_cache()
    if args.check_only or not ok:
        print(json.dumps({"ok": ok}))
        return 0 if ok else 1

    def ms(fn, it=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(it):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / it

    def device_ms(fn, it=50):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(it):
                fn()
            torch.cuda.synchronize()
        return sum(ev.self_device_time_total for ev in prof.key_averages()) / 1e3 / it

    res = {"device": smi}
    ends = ("other",) if "other" in trees else ()

    def turns(kernel):  # other, this, this's cut builds of the kernel and back
        mine = [label for label in cuts if CUTS[label][0] == kernel]
        return ends + ("this", *mine, *reversed(mine), "this") + ends

    trees.update(cuts)
    for n, s in TIMED:
        d = 128
        q, c, v, lq = inputs(n, d, seed=1)
        dce = torch.rand(n, device="cuda") * v
        diag, m = f.row_diag_and_shift_reference(q, c, v, lq, INV_T, 0.0)
        _, _, lse = f.ce_forward(q, c, v, lq, s, INV_T, 0.0)
        outs = empty_outs(n, d)
        fns = {name: launchers(kerns, q, c, v, lq, m, diag, lse, dce, outs, n, d, s, 0.0)
               for name, kerns in trees.items()}
        for k in ("ce_row_diag", "ce_fwd", "ce_dq", "ce_dc"):
            times = {name: [] for name in dict.fromkeys(turns(k))}
            for name in turns(k):
                times[name].append(ms(fns[name][k], 20 if n <= 8192 else 5))
            res[f"{k}_N{n}"] = times
            rate = ""
            if k == "ce_row_diag":  # its launch loop is host-bound: device time under the profiler too
                dev = {name: [] for name in times}
                for name in turns(k):
                    dev[name].append(device_ms(fns[name][k]))
                dev["torch.linalg.vecdot"] = [device_ms(lambda: torch.linalg.vecdot(q, c)) for _ in range(2)]
                res[f"{k}_N{n}_device"] = dev
                rate = "; device time " + ", ".join(f"{nm} {t} ms" for nm, t in dev.items())
            if k == "ce_fwd":  # one exponential per logit at 16 a clock per SM, 132 SMs, 1.98 GHz
                floor = n * n / (16 * 132 * 1.98e9) * 1e3
                res[f"{k}_N{n}_exp_floor_ms"] = floor
                rate = f"; exponential floor {floor:.4f} ms (this at {min(times['this']) / floor:.2f}x it)"
            if k in ("ce_dq", "ce_dc"):  # S and the gradient product: 4 N^2 D operations
                tflops = 4 * n * n * d / (min(times["this"]) * 1e-3) / 1e12
                res[f"{k}_N{n}_tflops"] = tflops
                rate = f"; this: the products at {tflops:.1f} TFLOP/s, {tflops / 989:.1%} of the 989 dense peak"
            print(f"[time] {k} N={n} s={s} D={d}: " + ", ".join(f"{nm} {t} ms" for nm, t in times.items()) + rate,
                  flush=True)
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
