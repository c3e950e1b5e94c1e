"""The port's data pipeline against the JAX package's: synth_data's columns
for a seed, and the batches ``get_host_dataloader`` yields from the same
parquet files (bit for bit, in the same order) for training (shuffled,
with and without the shuffle buffer and macro batches) and validation,
through the prefetch thread and without it; the in-memory store against
the local one; the row shuffle against pandas' ``sample``."""

import numpy as np
import pandas as pd
import pytest

from recommendations_tpu.config.yaml_loader import load_config as jax_load_config
from recommendations_tpu.config.yaml_loader import parse_cli_overrides as jax_parse
from recommendations_tpu.data.generator import get_data_loader_strategy as jax_strategy
from recommendations_tpu.data.loader import get_host_dataloader as jax_loader
from recommendations_tpu.data.paths import get_train_data_paths as jax_train_paths
from recommendations_tpu.data.paths import get_val_data_paths as jax_val_paths
from recommendations_tpu.tools import synth_data as jsynth
from recommendations_tpu_torch.config.yaml_loader import load_config, parse_cli_overrides
from recommendations_tpu_torch.data.data_store import FakeDataStore, read_parquet_table
from recommendations_tpu_torch.data.generator import get_data_loader_strategy, shuffle_rows
from recommendations_tpu_torch.data.loader import get_host_dataloader
from recommendations_tpu_torch.data.paths import get_train_data_paths, get_val_data_paths
from recommendations_tpu_torch.main_training import CONFIG_ROOT
from recommendations_tpu_torch.tools import synth_data as tsynth

HISTORY = 64
DATES = ["20240101", "20240102"]


@pytest.fixture(scope="module")
def parquet_root(tmp_path_factory):
    """JAX's synthetic dataset: 2 dates x 2 files of 40 users."""
    root = tmp_path_factory.mktemp("lthm_tiny_data")
    jsynth.write_synthetic_dataset(str(root), DATES, files_per_date=2, users_per_file=40, history_len=HISTORY)
    return root


def _same_value(p, q):
    if isinstance(p, (list, np.ndarray)) or isinstance(q, (list, np.ndarray)):
        return np.array_equal(np.asarray(p), np.asarray(q))
    return p == q


def _same_batch(a, b):
    assert list(a) == list(b)
    for k in a:
        x, y = a[k], np.asarray(b[k])
        if y.dtype == object:
            assert x.dtype == object and len(x) == len(y) and all(map(_same_value, x, y)), k
        else:
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


def _overrides(root, bypass, buffer, macro, kind="local"):
    fs = f"{{kind: local, local_dir_prefix: {root}, path_template: 'date={{date}}'}}" if kind == "local" else \
        "{kind: fake, path_template: 'date={date}'}"
    return ["model_version=v1", "run_id=r1", f"dataset.filesystem_config={fs}", "train.batch_size=16",
            f"data_loader.bypass_dataloader={str(bypass).lower()}",
            f"data_loader.shuffle_buffer_num_mini_batches={buffer}",
            f"data_loader.macro_batches_multiples={macro}"]


def _port_batches(cfg, kind, epoch=0):
    strategy = get_data_loader_strategy(cfg.data_loader, cfg.model.features.get_input_columns(), cfg.model.preprocess_fn)
    paths = get_train_data_paths(cfg.dataset) if kind == "train" else get_val_data_paths(cfg.dataset)
    loader = get_host_dataloader(kind, 0, paths, cfg.train.batch_size, None, strategy, cfg.model.features,
                                 cfg.dataset.filesystem_config, epoch=epoch)
    return list(loader)


@pytest.mark.parametrize("kind,bypass,buffer,macro", [
    ("train", False, 0, 1),   # lthm_tiny.yaml's loader: per-chunk shuffle, prefetch thread
    ("train", True, 0, 3),    # lthm_train.yaml's: no thread, macro batches of 3
    ("train", False, 2, 1),   # the shuffle buffer across chunks
    ("val", False, 2, 3),     # validation: no buffer, no macro batches, its own seed
    ("val", True, 0, 1),
])
def test_loader_batches_equal_jax(parquet_root, kind, bypass, buffer, macro):
    args = _overrides(parquet_root, bypass, buffer, macro)
    jcfg = jax_load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=jax_parse(args),
                           search_paths=[str(CONFIG_ROOT)])
    tcfg = load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=parse_cli_overrides(args),
                       search_paths=[str(CONFIG_ROOT)])
    jstrategy = jax_strategy(jcfg.data_loader, jcfg.model.features.get_input_columns(), jcfg.model.preprocess_fn)
    jpaths = jax_train_paths(jcfg.dataset) if kind == "train" else jax_val_paths(jcfg.dataset)
    for epoch in (0, 1):
        want = list(jax_loader(kind, 0, jpaths, jcfg.train.batch_size, None, jstrategy, jcfg.model.features,
                               jcfg.dataset.filesystem_config, epoch=epoch))
        got = _port_batches(tcfg, kind, epoch)
        assert len(got) == len(want) >= 4
        for g, w in zip(got, want):
            _same_batch(g, w)
    if kind == "train":  # each epoch has its own order
        assert not np.array_equal(_port_batches(tcfg, kind, 0)[0]["product_ids"],
                                  _port_batches(tcfg, kind, 1)[0]["product_ids"])


def test_synth_data_columns_equal_jax():
    for seed, hist, jump in ((0, 16, 0.0), (7, 64, 0.35)):
        df = jsynth._pad_lists(jsynth.make_click_log(num_users=30, history_len=hist, seed=seed,
                                                     p_in_cluster_jump=jump), hist)
        t = tsynth._pad_lists(tsynth.make_click_log(num_users=30, history_len=hist, seed=seed,
                                                    p_in_cluster_jump=jump), hist)
        assert list(t) == list(df.columns)
        for c in df.columns:
            for a, b in zip(t[c], df[c]):
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype and np.array_equal(a, b), c
                else:
                    assert a == b, c


def test_fake_store_batches_equal_the_local_store(tmp_path):
    """The port's synth_data in the in-memory store, and the same tables
    written to parquet and read back: the same batches."""
    FakeDataStore.reset()
    try:
        fake = tsynth.write_synthetic_dataset(None, DATES, 2, 24, HISTORY, seed=3, fake_store=True)
        local = tsynth.write_synthetic_dataset(str(tmp_path), DATES, 2, 24, HISTORY, seed=3)
        for f, lp in zip(fake, local):
            _same_batch(read_parquet_table(lp), FakeDataStore._tables[f])
        for kind in ("train", "val"):
            a = _port_batches(load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=parse_cli_overrides(
                _overrides(tmp_path, False, 0, 1)), search_paths=[str(CONFIG_ROOT)]), kind)
            b = _port_batches(load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=parse_cli_overrides(
                _overrides(tmp_path, False, 0, 1, kind="fake")), search_paths=[str(CONFIG_ROOT)]), kind)
            assert len(a) == len(b) == 3  # 2 files of 24 users, batches of 16
            for x, y in zip(a, b):
                _same_batch(x, y)
    finally:
        FakeDataStore.reset()


@pytest.mark.parametrize("seed", [0, 29, 1_000_032])
def test_row_shuffle_is_pandas_sample(seed):
    """pandas' sample(frac=1.0, random_state=...) draws
    RandomState.choice(n, n, replace=False), which is the permutation the
    port takes; for an integer seed and for a RandomState instance whose
    state is carried on."""
    n = 37
    df = pd.DataFrame({"x": np.arange(n), "y": [f"r{i}" for i in range(n)]})
    table = {"x": np.arange(n), "y": np.array([f"r{i}" for i in range(n)], dtype=object)}
    assert np.array_equal(df.sample(frac=1.0, random_state=seed)["x"].to_numpy(),
                          shuffle_rows(table, np.random.RandomState(seed))["x"])
    rs_pd, rs_np = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(3):
        want = df.sample(frac=1.0, random_state=rs_pd)
        got = shuffle_rows(table, rs_np)
        assert np.array_equal(want["x"].to_numpy(), got["x"]) and list(want["y"]) == list(got["y"])


def test_reader_without_pyarrow_names_it(monkeypatch, tmp_path):
    import builtins

    real_import = builtins.__import__

    def no_pyarrow(name, *args, **kw):
        if name.startswith("pyarrow"):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(ImportError, match="pyarrow"):
        read_parquet_table(str(tmp_path / "missing.parquet"))


@pytest.mark.parametrize("extra", [
    ["dataset.extra_day_val_data_start_date='20240103'"],  # one day after validation
    ["dataset.extra_day_val_data_start_date='20240102'", "dataset.extra_day_val_period_in_days=3",
     "dataset.extra_day_val_data_ratio=0.5"],  # three days, half the files
    ["dataset.extra_day_val_data_start_date='20240102'", "dataset.extra_day_val_period_in_days=3",
     "dataset.exclude_dates=['20240103']"],
    ["dataset.extra_day_val_data_start_date='20240103'", "dataset.extra_day_val_period_in_days=0"],  # no days
    [],  # no start date
])
def test_extra_day_val_paths_equal_jax(extra):
    """get_val_data_paths(..., for_extra_day=True) on the in-memory stores:
    JAX's files for the extra-day set, and the plain validation set unchanged."""
    from recommendations_tpu.data.data_store import FakeDataStore as JaxFakeDataStore

    dates = ["20240101", "20240102", "20240103", "20240104"]
    FakeDataStore.reset()
    JaxFakeDataStore.reset()
    try:
        for date in dates:
            for p in range(3):
                FakeDataStore.put_table(f"date={date}/part-{p:05d}.parquet", {"x": np.arange(2)})
                JaxFakeDataStore.put_table(f"date={date}/part-{p:05d}.parquet", pd.DataFrame({"x": np.arange(2)}))
        args = ["model_version=v1", "run_id=r1", "dataset.filesystem_config={kind: fake, path_template: 'date={date}'}",
                *extra]
        jcfg = jax_load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=jax_parse(args), search_paths=[str(CONFIG_ROOT)])
        tcfg = load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=parse_cli_overrides(args),
                           search_paths=[str(CONFIG_ROOT)])
        for_extra = get_val_data_paths(tcfg.dataset, for_extra_day=True)
        assert for_extra == jax_val_paths(jcfg.dataset, for_extra_day=True)
        assert get_val_data_paths(tcfg.dataset) == jax_val_paths(jcfg.dataset) == [
            f"date=20240102/part-{p:05d}.parquet" for p in range(3)]
        assert bool(for_extra) == bool(extra and "period_in_days=0" not in extra[-1])
    finally:
        FakeDataStore.reset()
        JaxFakeDataStore.reset()
