"""Run one cell of the port's benchmark.

    python3 benchmark/run.py --workload lthm_long.train --seed 7 --seconds 20 --trace 0

From the root of a checkout. Builds the cell that ``BENCHMARK.json`` names
(its configuration, traffic mix and metrics, each found by name under
``benchmark/``), sets up the program (``recommendations_tpu_torch``) with
the benchmark's weights and inputs from ``--seed``, measures ``--seconds``
of its traffic, and checks what the timed path produced against the plain
reference (``benchmark/reference/``). ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read from the same
run and a profiled sub-window after it.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``checks``: each number compared with its limit, which
are also the last lines of standard error. Exits non-zero, printing no
result, without a CUDA device, and if JAX, Flax or the JAX package has been
loaded.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"


def set_caches() -> None:
    """Compile caches at fixed paths inside the checkout, so only the first
    run of a checkout builds; the port's own nvcc builds land in
    ``recommendations_tpu_torch/ops/_build``."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_caches()
    sys.path[0] = str(ROOT)  # the checkout's root, not benchmark/
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("benchmark: no CUDA device", file=sys.stderr)
        return 2
    from benchmark.harness.cell import run_cell

    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    print(f"card: {card_line()}; devices {torch.cuda.device_count()}; torch {torch.__version__}", flush=True)
    result, stderr_lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                                    clock=lambda: time.perf_counter() - PROCESS_START)
    from benchmark.harness.core import forbidden_loaded

    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    result["device"].update(platform="gpu", kind=torch.cuda.get_device_name(0), count=1)
    for line in stderr_lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
