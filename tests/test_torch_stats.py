"""The port's stats job (recommendations_tpu_torch/pipeline/stats.py) against
the JAX package's (recommendations_tpu/pipeline/stats.py), on the CPU: the
quantiles are the same numpy arithmetic, so they are held equal bit for
bit; the pipeline hook on the same files and the ``stats:`` config section
through the entry point's config loader."""

import types

import numpy as np
import pandas as pd
import pytest

from recommendations_tpu.config.trainer_config import FileSystemConfig as JaxFileSystemConfig
from recommendations_tpu.data import FakeDataStore as JaxFakeStore
from recommendations_tpu.features import FeaturesConfig as JaxFeatures
from recommendations_tpu.pipeline import stats as jstats
from recommendations_tpu_torch.config.trainer_config import FileSystemConfig, FileSystemKind
from recommendations_tpu_torch.data.data_store import FakeDataStore
from recommendations_tpu_torch.features.feature_config import FeaturesConfig
from recommendations_tpu_torch.main_training import CONFIG_ROOT, load_config, parse_cli_overrides
from recommendations_tpu_torch.pipeline import stats as tstats


def _frames(seed=0):
    rs = np.random.RandomState(seed)
    frames = []
    for i in range(5):
        price = rs.randn(3000) * 10 + 50
        price[rs.rand(3000) < 0.05] = np.nan
        cols = {"price": price, "qty": rs.exponential(3.0, size=3000).round()}
        if i >= 2:  # a feature that first appears in the third table
            cols["late"] = rs.uniform(-1, 1, size=3000)
        if i == 4:
            cols["price"] = cols["price"] * 3 + 100  # outside the calibrated range: n_low / n_high
        frames.append(pd.DataFrame(cols))
    return frames


@pytest.mark.parametrize("num_bins,num_quantiles", [(400, 100), (50, 20), (7, 4)])
def test_quantiles_equal_jax(num_bins, num_quantiles):
    names = ["price", "qty", "late", "missing"]
    frames = _frames()
    want = jstats.compute_stats(jstats.StatsConfig(compute_stats=True, num_bins=num_bins,
                                                   num_quantiles=num_quantiles), names, iter(frames))
    got = tstats.compute_stats(tstats.StatsConfig(compute_stats=True, num_bins=num_bins,
                                                  num_quantiles=num_quantiles), names,
                               iter([{c: f[c].to_numpy() for c in f.columns} for f in frames]))
    assert set(got.to_dict()) == set(want.to_dict()) == {"price", "qty", "late"}
    for name in want.to_dict():
        assert got[name] == want[name], name  # python floats, bit for bit
        assert len(got[name]) == num_quantiles - 1


def test_constant_and_empty_features_as_jax():
    frames = [pd.DataFrame({"c": np.full(10, 2.5), "e": np.full(10, np.nan)})]
    cfg = dict(compute_stats=True, num_quantiles=5)
    want = jstats.compute_stats(jstats.StatsConfig(**cfg), ["c", "e"], iter(frames)).to_dict()
    got = tstats.compute_stats(tstats.StatsConfig(**cfg), ["c", "e"],
                               iter([{c: f[c].to_numpy() for c in f.columns} for f in frames])).to_dict()
    assert got == want and "e" not in got


def test_pipeline_hook_equals_jax_on_the_same_files():
    """compute_stats_for_pipeline over a data_ratio sample of the files
    (the same sample in both: sample_paths' seeded draw) of the numeric
    features, with both in-memory stores holding the same tables."""
    JaxFakeStore.reset()
    FakeDataStore.reset()
    paths = []
    for i, df in enumerate(_frames(seed=3) * 2):
        p = f"date=20240101/p{i}.parquet"
        JaxFakeStore.put_table(p, df)
        FakeDataStore.put_table(p, {c: df[c].to_numpy() for c in df.columns})
        paths.append(p)
    feats = {"defaults": {}, "numerical_features": [{"name": "price", "kind": "numerical"},
                                                    {"name": "qty", "kind": "numerical"}]}

    def cfg(features, stats_cls, fs):
        return types.SimpleNamespace(stats=stats_cls(compute_stats=True, data_ratio=0.5, num_quantiles=10),
                                     model=types.SimpleNamespace(features=features),
                                     dataset=types.SimpleNamespace(filesystem_config=fs))

    want = jstats.compute_stats_for_pipeline(
        cfg(JaxFeatures(**feats), jstats.StatsConfig, JaxFileSystemConfig(kind="fake")), paths)
    got = tstats.compute_stats_for_pipeline(
        cfg(FeaturesConfig.from_dict(feats), tstats.StatsConfig, FileSystemConfig(kind=FileSystemKind.FAKE)), paths)
    assert got.to_dict() == want.to_dict() and set(got.to_dict()) == {"price", "qty"}
    off = cfg(FeaturesConfig.from_dict(feats), tstats.StatsConfig, FileSystemConfig(kind=FileSystemKind.FAKE))
    off.stats.compute_stats = False
    assert tstats.compute_stats_for_pipeline(off, paths) is None


def test_stats_section_loads_as_its_config():
    """A ``stats:`` section no longer raises: it becomes StatsConfig, its
    data loader a DataLoaderConfig; lthm_tiny has no numeric feature, so
    the job returns None, as in the JAX package."""
    cfg = load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=parse_cli_overrides(
        ["stats={compute_stats: true, num_bins: 100, data_ratio: 0.5, data_loader: {block_size: 2}}"]),
        search_paths=[str(CONFIG_ROOT)])
    assert isinstance(cfg.stats, tstats.StatsConfig) and cfg.stats.num_bins == 100
    assert cfg.stats.data_loader.block_size == 2
    assert tstats.compute_stats_for_pipeline(cfg, []) is None
