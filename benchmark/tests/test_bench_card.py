"""On the card: one short run of each cell comes out correct, and the
control (the reference in float8 in the program's place) fails the cell's
check at the cell's own size. Skips without a card, decided inside the
test.

    python -m pytest --noconftest -m cuda benchmark/tests/test_bench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness.core import ROOT, benchmark_json

CELLS = [w["name"] for w in benchmark_json()["workloads"]]


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_bench_card_cell_is_correct(workload):
    need_card()
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "2147483659",
                          "--seconds", "2", "--trace", "1"], capture_output=True, text=True, cwd=str(ROOT),
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_bench_card_control_fails(workload):
    need_card()
    out = subprocess.run([sys.executable, "benchmark/controls.py", "--workload", workload, "--seeds", "2147483661"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    from benchmark.harness import checks

    for line in out.stdout.strip().splitlines():
        row = json.loads(line)
        assert not checks.judge(row["numbers"], row["limits"]), row
