"""The traffic generator: deterministic under a seed, and true to its
mix's parameters."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness.traffic import MIX_KEYS, make_pool, zipf_ranks

TRAFFIC = Path(__file__).resolve().parent.parent / "traffic"
SEED = 2**31 + 12345


def mix(name: str, **kw) -> dict:
    m = json.loads((TRAFFIC / f"{name}.json").read_text())
    m.update(kw)
    return m


@pytest.mark.parametrize("name", ["train64", "serve64"])
def test_bench_pool_same_seed_same_pool(name):
    m = mix(name, pool=2)
    a, b = make_pool(m, 300, 256, SEED), make_pool(m, 300, 256, SEED)
    c = make_pool(m, 300, 256, SEED + 1)
    for x, y in zip(a, b):
        for k in x:
            assert np.array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["product_ids"], c[0]["product_ids"])
    assert all(x["product_ids"].shape == y["product_ids"].shape for x, y in zip(a, c))


@pytest.mark.parametrize("name", ["train64", "serve64"])
def test_bench_pool_matches_its_parameters(name):
    context, history = 256, 300
    m = mix(name, pool=4)
    pool = make_pool(m, history, context, SEED)
    assert len(pool) == m["pool"]
    ids = np.concatenate([b["product_ids"] for b in pool])
    labels = np.concatenate([b["labels"] for b in pool])
    stamps = np.concatenate([b["timestamps"] for b in pool])
    assert ids.shape == (m["pool"] * m["users"], history) and ids.dtype == np.int64
    assert labels.dtype == stamps.dtype == np.float32
    lengths = (ids != 0).sum(1)
    # right-padded: every live event before every pad
    assert all((row[:n] != 0).all() and (row[n:] == 0).all() for row, n in zip(ids, lengths))
    assert lengths.min() >= m["min_events"] and lengths.max() <= context
    # log-uniform: about half the users below the geometric mean of the range
    below = np.mean(lengths < np.sqrt(m["min_events"] * context))
    assert 0.35 < below < 0.65
    live = ids != 0
    shares = np.asarray(m["action_shares"], dtype=np.float64)
    shares /= shares.sum()
    assert set(np.unique(labels[live])) <= set(range(shares.size))
    seen = np.bincount(labels[live].astype(np.int64), minlength=shares.size) / live.sum()
    assert np.allclose(seen, shares, atol=5 * np.sqrt(shares.max() / live.sum()))
    assert (labels[~live] == 0).all() and (stamps[~live] == 0).all()
    # most recent first: time decreases along a history
    d = np.diff(stamps.astype(np.float64), axis=1)
    assert (d[live[:, 1:]] <= 0).all()
    assert (stamps[:, 0] >= m["t_start"] - 1e3).all() and (stamps[:, 0] <= m["t_start"] + m["t_span"] + 1e3).all()


@pytest.mark.parametrize("name", ["train64", "serve64"])
def test_bench_mix_states_where_each_parameter_comes_from(name):
    m = mix(name)
    told = set(m["sourced"]) | set(m["assumed"])
    assert not set(m["sourced"]) & set(m["assumed"])
    assert told == set(MIX_KEYS) - {"driver"}


def test_bench_zipf_ranks_follow_the_law():
    rng = np.random.default_rng(SEED)
    a, n = 1.1, 1000
    r = zipf_ranks(rng, a, n, 200_000)
    counts = np.bincount(r, minlength=n)
    p = np.arange(1, n + 1, dtype=np.float64) ** -a
    p /= p.sum()
    for rank in (0, 1, 9):
        assert abs(counts[rank] / r.size - p[rank]) < 4 * np.sqrt(p[rank] / r.size)
