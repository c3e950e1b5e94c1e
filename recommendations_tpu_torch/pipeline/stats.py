"""Feature-statistics job: streaming quantiles over a sample of the data.

Port of ``recommendations_tpu/pipeline/stats.py`` (the ``stats:`` section
the reference configures, ``lthm_train.yaml:57-72``): one pass over a
sampled set of files accumulates a fixed-width histogram per numeric
feature between bounds calibrated on the first table (its range padded by
a quarter), then the quantiles come from the histogram's CDF. The
arithmetic is the JAX package's numpy, so the quantiles are its bits.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np

from recommendations_tpu_torch.config.trainer_config import DataLoaderConfig

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class StatsConfig:
    """Reference ``lthm_train.yaml:57-72`` schema."""

    compute_stats: bool = False
    num_bins: int = 400
    batch_size: int = 32
    data_ratio: float = 0.1
    num_quantiles: int = 100
    data_loader: Optional[DataLoaderConfig] = None


@dataclasses.dataclass
class _Hist:
    lo: float
    hi: float
    counts: np.ndarray
    n_low: int = 0
    n_high: int = 0

    def add(self, values: np.ndarray) -> None:
        values = values[np.isfinite(values)]
        if values.size == 0:
            return
        span = max(self.hi - self.lo, 1e-12)
        idx = np.floor((values - self.lo) / span * len(self.counts)).astype(np.int64)
        self.n_low += int((idx < 0).sum())
        self.n_high += int((idx >= len(self.counts)).sum())
        idx = idx[(idx >= 0) & (idx < len(self.counts))]
        np.add.at(self.counts, idx, 1)

    def quantiles(self, qs: np.ndarray) -> np.ndarray:
        total = self.counts.sum() + self.n_low + self.n_high
        if total == 0:
            return np.zeros_like(qs)
        cdf = (self.n_low + np.cumsum(self.counts)) / total
        edges = np.linspace(self.lo, self.hi, len(self.counts) + 1)[1:]
        return np.interp(qs, cdf, edges)


class Stats:
    """Computed feature stats: name -> sorted quantile list."""

    def __init__(self, quantiles: Dict[str, List[float]]):
        self.quantiles = quantiles

    def __getitem__(self, feature: str) -> List[float]:
        return self.quantiles[feature]

    def get(self, feature: str, default=None):
        return self.quantiles.get(feature, default)

    def to_dict(self) -> Dict[str, List[float]]:
        return self.quantiles


def compute_stats(stats_config: StatsConfig, feature_names: List[str], table_iter) -> Stats:
    """One pass over the tables (dicts of numpy columns); the first table
    holding a feature calibrates its bounds."""
    hists: Dict[str, _Hist] = {}
    qs = np.linspace(0.0, 1.0, stats_config.num_quantiles + 1)[1:-1]
    for table in table_iter:
        for name in feature_names:
            if name not in table:
                continue
            vals = np.asarray(table[name], dtype=np.float64)
            if name not in hists:
                finite = vals[np.isfinite(vals)]
                if finite.size == 0:
                    continue
                lo, hi = float(finite.min()), float(finite.max())
                pad = max((hi - lo) * 0.25, 1e-6)
                hists[name] = _Hist(lo - pad, hi + pad, np.zeros(stats_config.num_bins, np.int64))
            hists[name].add(vals)
    out = {name: [float(v) for v in h.quantiles(qs)] for name, h in hists.items()}
    logger.info("computed stats for %d features", len(out))
    return Stats(out)


def compute_stats_for_pipeline(pipeline_config, train_paths: List[str]) -> Optional[Stats]:
    """The stats of the pipeline's numeric features over a ``data_ratio``
    sample of the training files, or None without a ``stats`` section that
    asks for them (or without a numeric feature); the result goes to the
    model builder."""
    stats_config = getattr(pipeline_config, "stats", None)
    if stats_config is None or not stats_config.compute_stats:
        return None
    from recommendations_tpu_torch.data.data_store import DataStoreAccessor, sample_paths

    feats = pipeline_config.model.features
    numeric = [f.name for f in feats.numerical_features] + [f.name for f in feats.lat_lng_features]
    if not numeric:
        return None
    store = DataStoreAccessor.get_instance(pipeline_config.dataset.filesystem_config)
    paths = sample_paths(train_paths, stats_config.data_ratio)

    def tables():
        for p in paths:
            table = store.read_single_parquet_file(p)
            if table is not None:
                yield table

    return compute_stats(stats_config, numeric, tables())
