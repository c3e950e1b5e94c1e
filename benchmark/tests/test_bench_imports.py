"""What the harness loads: nothing whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``recommendations_tpu`` (compared whole: the port,
``recommendations_tpu_torch``, is allowed to the harness but not to the
reference). Each case imports in a fresh interpreter."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness.core import ROOT, benchmark_json

LOADED = """
import importlib, json, sys
sys.path.insert(0, {root!r})
for name in {mods!r}:
    importlib.import_module(name)
for path in {files!r}:
    from benchmark.harness.core import load_module
    load_module(__import__("pathlib").Path(path), "m")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(mods, files=()):
    code = LOADED.format(root=str(ROOT), mods=list(mods), files=[str(f) for f in files])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_bench_harness_loads_no_jax():
    bench = benchmark_json()
    files = [ROOT / "benchmark" / "metrics" / f"{m['name']}.py" for m in bench["end_to_end"] + bench["per_layer"]]
    files += list((ROOT / "benchmark" / "drivers").glob("*.py")) + list((ROOT / "benchmark" / "models").glob("*.py"))
    mods = ["benchmark.harness.cell", "benchmark.controls",
            "recommendations_tpu_torch.models.lthm.wrapper", "recommendations_tpu_torch.train.step"]
    loaded = top_level(mods, files)
    assert not loaded & {"jax", "jaxlib", "flax", "recommendations_tpu"}
    assert "recommendations_tpu_torch" in loaded


@pytest.mark.parametrize("module", ["benchmark.reference.lthm", "benchmark.arith.lthm", "benchmark.harness.traffic",
                                    "benchmark.harness.checks"])
def test_bench_yardstick_imports_nothing_of_the_program(module):
    loaded = top_level([module])
    assert not loaded & {"jax", "jaxlib", "flax", "recommendations_tpu", "recommendations_tpu_torch"}


def test_bench_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "lthm_long.train", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True, cwd=str(ROOT), timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
