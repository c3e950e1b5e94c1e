"""A tiny benchmark tree for the CPU tests: a copy of ``benchmark/`` with a
small LTHM configuration (``lthm_test.json``: the production structure at
test widths), small mixes and its own ``BENCHMARK.json``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.harness.core import ROOT, benchmark_json

TEST_CONFIG = Path(__file__).resolve().parent / "lthm_test.json"
# float32 on the CPU: the port and the reference agree to about 1e-5 (loss),
# 5e-3 (a leaf's gradient norm) and 3e-3 (a user vector)
TRAIN_LIMITS = {"loss_gap": 1e-3, "grad_gap": 0.03, "change_gap": 0.03}
SERVE_LIMITS = {"emb_gap_max": 0.02, "emb_gap_median": 0.01}


def tiny_root(tmp: Path, users: int = 8, pool: int = 4, compute_dtype: str = "bfloat16") -> Path:
    """A checkout-like tree under ``tmp`` whose cells ``test.train`` and
    ``test.serve`` run the tiny configuration; returns its root."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    cfg = json.loads(TEST_CONFIG.read_text())
    cfg["model_config"]["compute_dtype"] = compute_dtype
    (tmp / "benchmark" / "configs" / "lthm_test.json").write_text(json.dumps(cfg))
    bench = benchmark_json()
    bench["configs"] = [{"name": "lthm_test", "source": "a test", "file": "benchmark/configs/lthm_test.json",
                         "reduced": [], "why": "a test"}]
    bench["workloads"] = []
    for kind, limits in (("train", TRAIN_LIMITS), ("serve", SERVE_LIMITS)):
        mix = json.loads((ROOT / "benchmark" / "traffic" / f"{kind}64.json").read_text())
        mix.update(users=users, pool=pool, catalog=5000)
        (tmp / "benchmark" / "traffic" / f"tiny_{kind}.json").write_text(json.dumps(mix))
        (tmp / "benchmark" / "limits" / f"test.{kind}.json").write_text(json.dumps(limits))
        bench["workloads"].append({"name": f"test.{kind}", "config": "lthm_test", "traffic": f"tiny_{kind}",
                                   "chips": 1, "why": "a test"})
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = sorted({"test." + w.split(".")[-1] for w in m["workloads"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
