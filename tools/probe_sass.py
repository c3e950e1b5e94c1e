"""Whether kernels of this checkout compile to the same machine code (SASS)
as kernels of another copy of ``recommendations_tpu_torch/ops/csrc``.

    python3 tools/probe_sass.py --other traces/parent_csrc

Builds each source named in ``PAIRS`` from both trees (``--other`` holds the
other tree's ``*.cu`` and ``*.cuh``, e.g. ``git show
<commit>:recommendations_tpu_torch/ops/csrc/<file>``), dumps the SASS of
both libraries with ``cuobjdump -sass`` and compares each pair of kernels
instruction by instruction, with addresses and encodings stripped (a kernel
renamed or given another template argument keeps its instructions). Prints
what ``ptxas`` reports for every kernel it builds (registers, and spills
where there are any), one line per pair and a JSON summary as its last
line. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from recommendations_tpu_torch.ops.cuda_build import CSRC, build_library, find_nvcc, library_path  # noqa: E402

# (source, the other tree's kernel, this tree's kernel): the name and the
# integer and bool template arguments, as ``kernel_key`` writes them. The
# kernels that a change beside them should leave as they are.
HDS = (16, 32, 64)
PAIRS = [
    ("flash_fwd.cu", f"mqa_tc_fwd_kernel<{hd},0>", f"mqa_tc_fwd_kernel<{hd},0>") for hd in HDS
] + [
    ("flash_fwd.cu", f"mqa_tc_bias_fwd_kernel<{hd}>", f"mqa_tc_bias_fwd_kernel<{hd}>") for hd in HDS
] + [
    ("flash_bwd.cu", f"mqa_tc_dq_kernel<{hd},0>", f"mqa_tc_dq_kernel<{hd},0>") for hd in HDS
] + [
    ("flash_bwd.cu", f"mqa_tc_dkv_kernel<{hd}>", f"mqa_tc_dkv_kernel<{hd}>") for hd in HDS
] + [
    ("flash_bwd.cu", f"mqa_tc_bias_dkv_kernel<{hd},{ng}>", f"mqa_tc_bias_dkv_kernel<{hd},{ng}>")
    for hd in HDS for ng in (1, 2)
] + [
    ("flash_bwd.cu", f"mqa_mma_dq_kernel<{hd},1>", f"mqa_mma_dq_kernel<{hd},1>") for hd in HDS
] + [  # the CE kernels against their unrounded case (ROUND_S, the last argument, 0)
    ("fused_ce.cu", f"ce_grad_tc_kernel<{d},{s},{kind}>", f"ce_grad_tc_kernel<{d},{s},{kind},0>")
    for d in (16, 32, 64, 128) for s in (0, 1) for kind in (1, 2)
] + [
    ("fused_ce.cu", f"ce_fwd_tc_kernel<{d},{s}>", f"ce_fwd_tc_kernel<{d},{s},0>")
    for d in (16, 32, 64, 128) for s in (0, 1)
] + [
    ("fused_ce.cu", f"row_diag_kernel<{d}>", f"row_diag_kernel<{d},0>") for d in (16, 32, 64, 128)
]


def kernel_key(mangled: str) -> str:
    base = re.search(r"\d+([a-z_]*kernel[a-z_]*)I", mangled) or re.search(r"[a-z_]*kernel[a-z_]*", mangled)
    name = base.group(1) if base.re.groups else base.group(0)
    return name + "<" + ",".join(re.findall(r"L[ib](\d+)E", mangled)) + ">"


def sass_of(lib: Path) -> dict:
    """{kernel key: [instructions]} of a built library."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    kernels, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = kernels.setdefault(kernel_key(m.group(1)), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if cur is not None and m:
            cur.append(m.group(1))
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True, help="a directory with another copy of ops/csrc")
    args = ap.parse_args()
    libs = {}
    for source in sorted({src for src, _, _ in PAIRS}):
        for tree, path in (("other", Path(args.other) / source), ("this", CSRC / source)):
            _, log = build_library(path)
            libs[(tree, source)] = sass_of(library_path(path))
            entry = ""
            for line in log.splitlines():  # what ptxas reports, where this call built the library
                if "Compiling entry function" in line:
                    entry = kernel_key(line.split("'")[1])
                elif "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                    print(f"[ptxas] {tree} {source} {entry}: {line.split(':', 1)[-1].strip()}", flush=True)
    res, same_all = {}, True
    for source, theirs, ours in PAIRS:
        a, b = libs[("other", source)].get(theirs), libs[("this", source)].get(ours)
        if a is None or b is None:
            print(f"[sass] {source} {theirs} | {ours}: missing ({'other' if a is None else 'this'})", flush=True)
            res[ours] = None
            same_all = False
            continue
        differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        res[ours] = {"other_instructions": len(a), "this_instructions": len(b), "differ": differ}
        same_all &= differ == 0
        print(f"[sass] {source} {theirs} | {ours}: {len(a)} | {len(b)} instructions, "
              f"{'identical' if differ == 0 else f'{differ} differ'}", flush=True)
    print(json.dumps({"identical": same_all, "kernels": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
