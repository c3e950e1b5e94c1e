"""Quick check of the fused contrastive-CE kernels alone on the card.

    python3 tools/probe_fused_ce.py

Builds ``recommendations_tpu_torch/ops/csrc/fused_ce.cu`` (printing what
``ptxas`` reports for each kernel), runs the forward and backward wrappers at
four shapes against their plain versions (ce error relative to 1 + |ce|, the
rows whose rank differs, dq and dc errors over their largest element, two
runs for the same bits), and times the forward wrapper (the shift, ``ce_row_diag``
and ``ce_fwd``) and the backward wrapper (``ce_dq`` and ``ce_dc``) at one
32-user loss chunk of LTHM-base (N = 8192, D = 128). Needs a card; imports
nothing of JAX. ``chip_smoke.py`` holds the same kernels to stated
tolerances and times each alone.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_fused_ce: no CUDA device", file=sys.stderr)
        return 1
    from recommendations_tpu_torch.ops import fused_ce as f

    t0 = time.time()
    for k in f.KERNELS:
        k.build()
    print("built in", time.time() - t0)
    for line in f.CE_FWD.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line or "Compiling" in line:
            print("  ", line.strip())

    def inputs(n, d, seed=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.nn.functional.normalize(torch.randn(n, d, generator=g, device="cuda"), dim=-1).bfloat16()
        c = torch.nn.functional.normalize(torch.randn(n, d, generator=g, device="cuda"), dim=-1).bfloat16()
        v = torch.rand(n, generator=g, device="cuda") > 0.1
        lq = -torch.rand(n, generator=g, device="cuda") * 10
        return q, c, v, lq

    for n, s, d, beta in [(8192, 256, 128, 0.0), (100, 10, 16, 1.0), (8448, 264, 64, 1.0), (512, 32, 32, 0.5)]:
        q, c, v, lq = inputs(n, d)
        ce, rank, lse = f.ce_forward(q, c, v, lq, s, 20.0, beta)
        torch.cuda.synchronize()
        rce, rrank, rlse = f.ce_forward_reference(q, c, v, lq, s, 20.0, beta)
        fin = torch.isfinite(rce)
        err = ((ce - rce).abs() / (1 + rce.abs()))[fin].max().item()
        nrank = (rank != rrank).sum().item()
        dce = torch.rand(n, device="cuda") * v
        dq, dc = f.ce_backward(q, c, v, lq, lse, dce, s, 20.0, beta)
        torch.cuda.synchronize()
        rdq, rdc = f.ce_backward_reference(q, c, v, lq, rlse, dce, s, 20.0, beta)
        edq = (dq.float() - rdq.float()).abs().max().item() / rdq.float().abs().max().item()
        edc = (dc.float() - rdc.float()).abs().max().item() / rdc.float().abs().max().item()
        dq2, dc2 = f.ce_backward(q, c, v, lq, lse, dce, s, 20.0, beta)
        det = torch.equal(dq, dq2) and torch.equal(dc, dc2)
        print(f"n={n} s={s} d={d} beta={beta}: ce rel err {err:.3e}, rank differs on {nrank} rows, "
              f"dq err/max {edq:.3e}, dc err/max {edc:.3e}, deterministic {det}, finite "
              f"{bool(torch.isfinite(dq.float()).all() and torch.isfinite(dc.float()).all())}", flush=True)

    q, c, v, lq = inputs(8192, 128)
    dce = torch.rand(8192, device="cuda")
    _, _, lse = f.ce_forward(q, c, v, lq, 256, 20.0, 0.0)

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

    print("fwd ms", ms(lambda: f.ce_forward(q, c, v, lq, 256, 20.0, 0.0)))
    print("bwd ms", ms(lambda: f.ce_backward(q, c, v, lq, lse, dce, 256, 20.0, 0.0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
