"""The harness end to end on the CPU at a tiny size, its check against
planted faults and against the control, and a metric added as a file.

The CPU cells run the port's plain paths in float32 (``compute_dtype``
float32, the LSH products too), where the port and the reference agree to
rounding, so the tiny limits can be tight; what bf16 reads on the card sets
the cells' own limits (PERF.md)."""

from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import checks
from benchmark.harness.cell import run_cell
from benchmark.tests.helpers import SERVE_LIMITS, TRAIN_LIMITS, tiny_root

CPU = torch.device("cpu")
SEED = 3_000_000_017  # wider than 32 bits, as the driver's seeds


def f32_lsh(model):
    """Build the program with its LSH products in float32 too."""
    build = model.build_program

    def build_f32(cfg, weights, device):
        wrapper = build(cfg, weights, device)
        for m in wrapper.module.modules():
            if type(m).__name__ == "CosineVectorEmbedding":
                m.compute_dtype = torch.float32
        return wrapper

    return build_f32


@pytest.fixture()
def root(tmp_path: Path) -> Path:
    return tiny_root(tmp_path, compute_dtype="float32")


def run(root: Path, workload: str, trace: bool = False, patch=None, monkeypatch=None):
    """One run of a tiny cell; ``patch(model_module, monkeypatch)`` plants
    a fault in the program's path before the run."""
    from benchmark.harness import core

    load = core.load_module

    def load_and_patch(path, name):
        mod = load(path, name)
        if path.parent.name == "models":
            monkeypatch.setattr(mod, "build_program", f32_lsh(mod))
            if patch is not None:
                patch(mod, monkeypatch)
        return mod

    monkeypatch.setattr("benchmark.harness.cell.load_module", load_and_patch)
    t0 = time.perf_counter()
    return run_cell(workload, SEED, 0.5, trace, CPU, clock=lambda: time.perf_counter() - t0, root=root)


@pytest.mark.parametrize("workload", ["test.train", "test.serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_bench_tiny_cell_runs_correct(root, workload, trace, monkeypatch):
    result, lines = run(root, workload, trace, monkeypatch=monkeypatch)
    assert result["correct"], lines
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert lines[-len(result["checks"]):] == [
        f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in result["checks"].items()]
    rate = "train_examples_per_s" if workload.endswith("train") else "serve_users_per_s"
    if trace:
        assert f"dispatch_ms.{workload.split('.')[1]}" in result["metrics"]
        assert "breakdown" in result and "window_s" in result["device"]
        assert rate not in result["metrics"]
    else:
        assert rate in result["metrics"] and "setup_s" in result["metrics"]
        # device numbers are never written from a CPU run
        assert "peak_mem_gib" not in result["metrics"]


def _unchanged(mod, mp):
    step = mod.train_step_fn()

    def frozen_step(state, batch):
        mp.setattr(state.optimizer, "step", lambda: None)
        return step(state, batch)

    mp.setattr(mod, "train_step_fn", lambda: frozen_step)


def _half_batch(mod, mp):
    step = mod.train_step_fn()
    mp.setattr(mod, "train_step_fn", lambda: lambda state, batch: step(
        state, {k: v[: v.shape[0] // 2] for k, v in batch.items()}))


def _answer_altered(mod, mp):
    def serve_fn(wrapper):
        enc = wrapper.inference_models()["user_encoder"]

        def altered(batch):
            emb = enc(batch)["user_emb"].clone()
            emb[0] = -emb[0]
            return {"user_emb": emb}

        return altered

    mp.setattr(mod, "serve_fn", serve_fn)


def _half_served(mod, mp):
    def serve_fn(wrapper):
        enc = wrapper.inference_models()["user_encoder"]

        def half(batch):
            n = next(iter(batch.values())).shape[0]
            emb = enc({k: v[: n // 2] for k, v in batch.items()})["user_emb"]
            return {"user_emb": torch.cat([emb, torch.zeros_like(emb)])}

        return half

    mp.setattr(mod, "serve_fn", serve_fn)


@pytest.mark.parametrize("workload,fault", [
    ("test.train", _unchanged),
    ("test.train", _half_batch),
    ("test.serve", _answer_altered),
    ("test.serve", _half_served),
])
def test_bench_planted_fault_is_not_correct(root, workload, fault, monkeypatch):
    result, lines = run(root, workload, patch=fault, monkeypatch=monkeypatch)
    assert not result["correct"], lines


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_bench_control_fails_the_check(kind):
    """The reference in float8 in the program's place, at the tiny size,
    against the float32 reference: the check says not correct."""
    import json

    from benchmark.harness.core import SEED_OFFSETS, SEED_TRAFFIC, SEED_WEIGHTS, sub_seed
    from benchmark.harness.traffic import make_pool
    from benchmark.models import lthm as model
    from benchmark.tests.helpers import TEST_CONFIG

    config = json.loads(TEST_CONFIG.read_text())
    cfg = config["model_config"]
    mix = json.loads((TEST_CONFIG.parent.parent / "traffic" / f"{kind}64.json").read_text())
    mix.update(users=8, pool=4, catalog=5000)
    pool = make_pool(mix, config["history_length"], cfg["context_width"], sub_seed(SEED, SEED_TRAFFIC))
    weights = model.make_weights(cfg, sub_seed(SEED, SEED_WEIGHTS), CPU)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in pool[:3]]
    if kind == "train":
        ref = model.reference_train(cfg, weights, batches, sub_seed(SEED, SEED_OFFSETS))
        ctl = model.reference_train(cfg, weights, batches, sub_seed(SEED, SEED_OFFSETS), precision="fp8")
        numbers, limits = checks.train_numbers(ctl, ref), TRAIN_LIMITS
    else:
        gaps = torch.cat([(model.reference_serve(cfg, weights, b, "fp8") - model.reference_serve(cfg, weights, b))
                          .norm(dim=-1) for b in batches])
        numbers, limits = {"emb_gap_max": float(gaps.max()), "emb_gap_median": float(gaps.median())}, SERVE_LIMITS
    assert not checks.judge(numbers, limits), numbers


def test_bench_metric_added_as_a_file(root, monkeypatch):
    """A new per-layer metric is one file and one entry: the harness finds
    it by name and reports it."""
    import json

    (root / "benchmark" / "metrics" / "steps_in_window.train.py").write_text(
        'UNIT = "steps"\nBETTER = "higher"\nLAYER = "entry: train/step.py, models/lthm/wrapper.py"\n'
        'MOVES = "train_examples_per_s"\nSOURCE = "host_clock"\n\n\ndef read(run):\n    return run.units\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_in_window.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "entry: train/step.py, models/lthm/wrapper.py",
                               "moves": "train_examples_per_s", "workloads": ["test.train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = run(root, "test.train", trace=True, monkeypatch=monkeypatch)
    assert result["metrics"]["steps_in_window.train"]["value"] >= 1


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_bench_idle_share_is_the_trace_own(kind):
    """``device_idle_pct.*`` reads the device profile alone: the union of its
    ops' spans (overlapping ops counted once) over its own window."""
    from benchmark.harness.core import ROOT, Run, Trace, device_activity, load_module

    events = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 40.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "b", "ts": 20.0, "dur": 40.0},
              {"ph": "X", "cat": "kernel", "name": "c", "ts": 80.0, "dur": 10.0}]
    ops, busy = device_activity(events)
    assert busy == 70.0
    trace = Trace(device_ops=ops, window_us=100.0, busy_us=busy, ops=[], idle_gaps=[], units=2)
    run = Run(cell=None, seed=0, seconds=1.0, window_s=50.0, units=1, trace=trace)
    reader = load_module(ROOT / "benchmark" / "metrics" / f"device_idle_pct.{kind}.py", f"idle_{kind}")
    assert reader.read(run) == pytest.approx(30.0)
    run.trace = None
    assert reader.read(run) is None
