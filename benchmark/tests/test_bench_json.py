"""``BENCHMARK.json`` against the contract it is checked by: names, units
and lines in the allowed characters, and every entry resolving to its
files, whose own constants agree with the entry."""

from __future__ import annotations

import re

import pytest

from benchmark.harness.core import ROOT, benchmark_json, load_cell, load_module, read_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = benchmark_json()
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bench_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(line_ok(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert not word.startswith("/") and any(word.startswith(p + "/") for p in BENCH["paths"])


def test_bench_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(NAME.match(e["name"]) for e in entries)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line_ok(w["why"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and line_ok(m["layer"])
        assert m["better"] in ("lower", "higher")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_bench_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(mine) >= 2
        layers = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layers
        for m in layers:  # the metric it moves is reported in the cell
            assert w["name"] in e2e[m["moves"]].get("workloads", [w["name"]])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_bench_every_cell_resolves_to_its_files(workload):
    cell = load_cell(BENCH, workload)
    bench_dir = ROOT / "benchmark"
    assert (bench_dir / "models" / f"{cell.config['model']}.py").is_file()
    assert (bench_dir / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    c = next(c for c in BENCH["configs"] if c["name"] == cell.config_name)
    assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
    # BENCHMARK.json's ``reduced`` names every top-level key changed from the
    # source; the file tells the changes (``changed``) from the cuts of scale
    changed = {k.split(".")[0] for k in cell.config["changed"]} | set(cell.config["reduced"])
    assert sorted(c["reduced"]) == sorted(changed)
    assert cell.config["source"] == c["source"]


def test_bench_config_files_differ():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    prod, long = (read_json(ROOT / f)["model_config"] for f in files[:2])
    assert prod != long


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_bench_metric_file_agrees_with_its_entry(metric):
    mod = load_module(ROOT / "benchmark" / "metrics" / f"{metric['name']}.py", "m_" + metric["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (metric["unit"], metric["better"], metric["source"])
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])
    assert callable(mod.read)
