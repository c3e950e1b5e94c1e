"""The port's S3 store and mlflow tracker against the JAX package's, on the
CPU, with stand-in ``boto3`` and ``mlflow`` modules in ``sys.modules``
(both are optional dependencies): each stand-in records every call it
gets, and the port's calls under it must equal JAX's, call for call and
argument for argument. Also: the retry's doubling backoff and its raise on the last
attempt; the paths by prefix, filtered and sampled; a parquet read through
``get_file_from_path``; ``get_file_from_path`` on the local and in-memory
stores; the store and the tracker without their module (``ImportError``
when the store is made; the tracker a no-op with one warning, as JAX's);
``Tracker.watch`` and the facade's ``watch``."""

import importlib
import io
import logging
import random
import sys
import time
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from recommendations_tpu.config.trainer_config import FileSystemConfig as JaxFileSystemConfig
from recommendations_tpu.data import data_store as jds
from recommendations_tpu.trackers import facade as jfacade
from recommendations_tpu_torch.config.trainer_config import FileSystemConfig
from recommendations_tpu_torch.data import data_store as tds
from recommendations_tpu_torch.trackers import facade as tfacade
from recommendations_tpu_torch.trackers.base import Tracker

BUCKET = "bucket-a"
KEYS = ["date=20240101/part-0.parquet", "date=20240101/_SUCCESS", "date=20240101/part-1.parquet",
        "date=20240101/.part-1.parquet.crc", "date=20240102/part-0.parquet", "date=20240102/sub/part-9.parquet"]


def _parquet_bytes():
    table = pa.table({"id": np.arange(5, dtype=np.int64), "price": np.linspace(0, 1, 5).astype(np.float32),
                      "name": ["a", "b", "c", "d", "e"]})
    buf = io.BytesIO()
    pq.write_table(table, buf)
    return buf.getvalue()


class StandInError(Exception):
    pass


def _boto3(calls, fail_get=0):
    """A stand-in ``boto3``: a resource listing KEYS by prefix, a client
    serving one parquet file (failing its first ``fail_get`` reads) and
    taking uploads; each call recorded in ``calls``."""
    body = _parquet_bytes()
    failures = {"get": fail_get}

    class Objects:
        def __init__(self, bucket):
            self.bucket = bucket

        def filter(self, Prefix):
            calls.append(("filter", self.bucket, Prefix))
            return iter([types.SimpleNamespace(key=k) for k in KEYS if k.startswith(Prefix)])

    class Resource:
        def Bucket(self, name):
            calls.append(("Bucket", name))
            return types.SimpleNamespace(objects=Objects(name))

    class Client:
        def get_object(self, Bucket, Key):
            calls.append(("get_object", Bucket, Key))
            if failures["get"] > 0:
                failures["get"] -= 1
                raise StandInError("throttled")
            return {"Body": io.BytesIO(body)}

        def upload_file(self, src, bucket, key):
            calls.append(("upload_file", src, bucket, key))

    mod = types.ModuleType("boto3")
    mod.resource = lambda name: calls.append(("resource", name)) or Resource()
    mod.client = lambda name: calls.append(("client", name)) or Client()
    return mod


@pytest.fixture
def quiet_backoff(monkeypatch):
    """Record the backoff's sleeps instead of sleeping; a fixed jitter."""
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    monkeypatch.setattr(random, "random", lambda: 0.25)
    return sleeps


def _stores(monkeypatch, fail_get=0, max_retries=5):
    """(port's calls, JAX's calls, port store, JAX store) under one stand-in
    each."""
    calls = {"port": [], "jax": []}
    stores = {}
    for who, mod, cfg in (("port", tds, FileSystemConfig), ("jax", jds, JaxFileSystemConfig)):
        monkeypatch.setitem(sys.modules, "boto3", _boto3(calls[who], fail_get))
        stores[who] = mod.S3DataStore(cfg(kind="s3", s3_bucket_path=BUCKET), max_retries=max_retries)
    return calls, stores


def test_s3_store_calls_equal_jax(monkeypatch, tmp_path, quiet_backoff):
    """Listing (the _SUCCESS and .crc files out, sorted, a half sampled), a
    read by ``s3://`` path and by key, and an upload: the same calls, the
    same paths, the same table."""
    calls, stores = _stores(monkeypatch)
    for k in (1.0, 0.5):
        got = stores["port"].get_training_data_paths_for_dates(["20240101", "20240102"], data_ratio=k)
        want = stores["jax"].get_training_data_paths_for_dates(["20240101", "20240102"], data_ratio=k)
        assert got == want and all(p.startswith(f"s3://{BUCKET}/") for p in got)
    assert len(got) == 2
    for path in (f"s3://{BUCKET}/{KEYS[0]}", KEYS[2]):
        assert stores["port"].get_file_from_path(path) == stores["jax"].get_file_from_path(path)
        table = stores["port"].read_single_parquet_file(path, columns=["id", "price"])
        df = stores["jax"].read_single_parquet_file(path, columns=["id", "price"])
        assert list(table) == list(df.columns)
        for c in table:
            np.testing.assert_array_equal(table[c], df[c].to_numpy())
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "x.json").write_text("{}")
    (tmp_path / "a" / "b" / "y.pt").write_bytes(b"\0")
    for s in stores.values():
        s.upload_dir_recursive(str(tmp_path / "a"), "ranker/v1")
    assert calls["port"] == calls["jax"]
    assert ("upload_file", str(tmp_path / "a" / "b" / "y.pt"), BUCKET, "ranker/v1/b/y.pt") in calls["port"]
    assert not quiet_backoff


def test_s3_retry_backs_off_then_raises_on_the_last_attempt(monkeypatch, quiet_backoff):
    """Two throttled reads then a good one: delays 1 and 2 plus the jitter;
    three of three throttled: the error raised (and a table read gives
    None, as JAX's), the same calls and delays as JAX's."""
    calls, stores = _stores(monkeypatch, fail_get=2, max_retries=3)
    for s in stores.values():
        assert s.get_file_from_path(KEYS[0]) == _parquet_bytes()
    assert quiet_backoff == [1.25, 2.25] * 2
    quiet_backoff.clear()
    calls, stores = _stores(monkeypatch, fail_get=10, max_retries=3)
    for s in stores.values():
        with pytest.raises(StandInError):
            s.get_file_from_path(KEYS[0])
        assert s.read_single_parquet_file(KEYS[0]) is None
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 2 + 6
    assert quiet_backoff == [1.25, 2.25] * 4


def test_s3_store_without_boto3_raises_when_made(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    for mod, cfg in ((tds, FileSystemConfig), (jds, JaxFileSystemConfig)):
        with pytest.raises(ImportError, match="boto3"):
            mod.S3DataStore(cfg(kind="s3", s3_bucket_path=BUCKET))


def test_get_file_from_path_on_every_store(tmp_path):
    path = tmp_path / "f.bin"
    path.write_bytes(b"abc\0")
    assert tds.LocalDataStore(FileSystemConfig(kind="local", local_dir_prefix=str(tmp_path))).get_file_from_path(
        str(path)) == jds.LocalDataStore(JaxFileSystemConfig(kind="local", local_dir_prefix=str(tmp_path))
                                         ).get_file_from_path(str(path)) == b"abc\0"
    tds.FakeDataStore.reset()
    jds.FakeDataStore.reset()
    try:
        for store in (tds.FakeDataStore(), jds.FakeDataStore()):
            store.upload_dir_recursive(str(tmp_path), "out")
            assert store.get_file_from_path("out/f.bin") == b"abc\0"
    finally:
        tds.FakeDataStore.reset()
        jds.FakeDataStore.reset()


# -- the mlflow tracker ---------------------------------------------------------------


def _mlflow(calls):
    """A stand-in ``mlflow``: experiment "known" exists (id "7"), others are
    created ("new-id"); a run id it does not know fails ``start_run``; the
    parameter "bad" fails ``log_param``."""
    mod = types.ModuleType("mlflow")

    def rec(name, result=None, fail=lambda *a, **k: False):
        def call(*args, **kw):
            calls.append((name, args, tuple(sorted(kw.items()))))
            if fail(*args, **kw):
                raise StandInError(name)
            return result(*args, **kw) if callable(result) else result
        return call

    mod.set_tracking_uri = rec("set_tracking_uri")
    mod.get_experiment_by_name = rec(
        "get_experiment_by_name", lambda n: types.SimpleNamespace(experiment_id="7") if n == "known" else None)
    mod.create_experiment = rec("create_experiment", "new-id")
    mod.start_run = rec("start_run", fail=lambda run_id=None, **k: run_id == "unknown")
    mod.end_run = rec("end_run")
    mod.log_param = rec("log_param", fail=lambda k, v: k == "bad")
    mod.log_metrics = rec("log_metrics")
    mod.log_artifacts = rec("log_artifacts")
    return mod


def _mlflow_trackers(monkeypatch, calls):
    """(port's tracker, JAX's), each module imported afresh under its own
    stand-in; built through each facade from the same YAML dict."""
    out = []
    for who, facade, name in (("port", tfacade, "recommendations_tpu_torch.trackers.mlflow_tracker"),
                              ("jax", jfacade, "recommendations_tpu.trackers.mlflow_tracker")):
        monkeypatch.setitem(sys.modules, "mlflow", _mlflow(calls[who]))
        importlib.reload(importlib.import_module(name))
        d = {"experiment": "known", "run_id": "r1",
             "trackers": [{"kind": "mlflow", "tracking_uri": "file:/tmp/x", "experiment_name": "default"}]}
        cfg = tfacade.TrainingTrackersConfig.from_dict(d) if who == "port" else jfacade.TrainingTrackersConfig(**d)
        assert type(cfg.trackers[0]).__name__ == "MlflowTracker"
        out.append(cfg.trackers[0])
    return out


@pytest.fixture
def fresh_mlflow_modules():
    """Each mlflow tracker module imported again without the stand-in after
    the test, as a run without mlflow finds it."""
    yield
    sys.modules.pop("mlflow", None)
    for name in ("recommendations_tpu_torch.trackers.mlflow_tracker", "recommendations_tpu.trackers.mlflow_tracker"):
        if name in sys.modules:
            importlib.reload(sys.modules[name])


def test_mlflow_tracker_calls_equal_jax(monkeypatch, tmp_path, fresh_mlflow_modules):
    """A run resumed by id, one started by name after an unknown id and one
    in a new experiment; parameters (a failing one skipped), metrics (the
    numeric ones, as floats), artifacts, both ends."""
    calls = {"port": [], "jax": []}
    port, jax_t = _mlflow_trackers(monkeypatch, calls)
    for t in (port, jax_t):
        t.start_run(run_id="r1", experiment="known")
        t.log_params({"a": 1, "bad": 2, "c": "x"})
        t.log_metrics({"loss": np.float32(0.5), "steps": 3, "name": "x", "none": None}, step=64)
        t.log_artifacts(str(tmp_path))
        t.end_run(error=True)
        t.start_run(run_id="unknown", experiment=None)
        t.end_run()
        t.start_run(run_id=None, experiment="fresh")
        t.watch(object())
    assert calls["port"] == calls["jax"]
    assert ("log_metrics", ({"loss": 0.5, "steps": 3.0},), (("step", 64),)) in calls["port"]
    assert ("start_run", (), (("experiment_id", "new-id"), ("run_name", "unknown"))) in calls["port"]
    assert ("end_run", (), (("status", "FAILED"),)) in calls["port"]


def test_mlflow_tracker_without_mlflow_is_a_no_op(monkeypatch, caplog, fresh_mlflow_modules):
    monkeypatch.setitem(sys.modules, "mlflow", None)
    mod = importlib.reload(importlib.import_module("recommendations_tpu_torch.trackers.mlflow_tracker"))
    cfg = tfacade.TrainingTrackersConfig.from_dict({"trackers": [{"kind": "mlflow"}]})
    t = cfg.trackers[0]
    assert isinstance(t, mod.MlflowTracker) and t.experiment_name == "default"
    with caplog.at_level(logging.WARNING):
        cfg.start_run()
        cfg.log_params({"a": 1})
        cfg.log_metrics({"loss": 1.0}, step=1)
        cfg.log_artifacts("/nonexistent")
        cfg.end_run()
    warned = [r for r in caplog.records if "mlflow" in r.getMessage()]
    assert len(warned) == 1 and "no-op" in warned[0].getMessage()


def test_facade_watch_reaches_every_tracker():
    class Watching(Tracker):
        def __init__(self):
            self.kind, self.seen = "watching", []

        def watch(self, model, log_graph=False):
            self.seen.append((model, log_graph))

    model = object()
    ts = [Watching(), Watching()]
    cfg = tfacade.TrainingTrackersConfig(trackers=ts + [Tracker(kind="base")])
    cfg.watch(model, log_graph=True)
    assert [t.seen for t in ts] == [[(model, True)]] * 2
    assert Tracker(kind="x").watch(model) is None
