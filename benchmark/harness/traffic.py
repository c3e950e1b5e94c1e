"""The one traffic generator: a mix's parameter file (``benchmark/traffic/
<mix>.json``) and a seed in, a pool of batches of user histories out.

Each user is drawn from the seed alone:

- a history length log-uniform over ``[min_events, context]``, the array
  right-padded with the pad token 0 to the configuration's
  ``history_length``, most recent event first, as the feature pipeline
  pads it;
- product ids from a Zipf(``zipf_a``) popularity over a catalog of
  ``catalog`` ids, each catalog entry a nonzero int64 drawn from the seed
  standing for its xxHash;
- actions (``labels``) drawn with the shares ``action_shares`` over
  ``0 .. len(action_shares) - 1``;
- ``timestamps`` that increase with time: the most recent event in
  ``[t_start, t_start + t_span)``, each earlier one an exponential gap of
  mean ``gap_mean_s`` seconds before it.

A mix file states where each parameter comes from: a public source
(``sourced``) or an argument (``assumed``).

Every seed gives the same shapes, so the work of a step or a request does
not depend on the seed; what the seed changes is which users, ids and
lengths the pool holds.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

MIX_KEYS = ("driver", "users", "pool", "min_events", "zipf_a", "catalog", "action_shares", "gap_mean_s",
            "t_start", "t_span")


def check_mix(mix: dict) -> None:
    missing = [k for k in MIX_KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")


def catalog_ids(rng: np.random.Generator, n: int) -> np.ndarray:
    ids = rng.integers(-(2**63), 2**63 - 1, size=n, dtype=np.int64, endpoint=True)
    ids[ids == 0] = 1  # 0 is the pad token
    return ids


def zipf_ranks(rng: np.random.Generator, a: float, n_items: int, size) -> np.ndarray:
    """Ranks 0 .. n_items - 1 with P(r) proportional to (r + 1)^-a."""
    cdf = np.cumsum(np.arange(1, n_items + 1, dtype=np.float64) ** -a)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(size), side="right"), n_items - 1)


def make_pool(mix: dict, history_length: int, context: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """``mix["pool"]`` batches of ``mix["users"]`` users: dicts of
    ``product_ids`` (int64), ``labels`` and ``timestamps`` (float32), each
    (users, history_length)."""
    check_mix(mix)
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**64, 7]))
    catalog = catalog_ids(rng, int(mix["catalog"]))
    n_users, length = int(mix["pool"]) * int(mix["users"]), int(history_length)
    hi = min(int(context), length)
    lo = min(int(mix["min_events"]), hi)
    lengths = np.floor(np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=n_users))).astype(np.int64)
    lengths = np.clip(lengths, lo, hi)
    live = np.arange(length)[None, :] < lengths[:, None]
    ids = np.where(live, catalog[zipf_ranks(rng, float(mix["zipf_a"]), catalog.size, (n_users, length))], 0)
    shares = np.asarray(mix["action_shares"], dtype=np.float64)
    actions = rng.choice(shares.size, p=shares / shares.sum(), size=(n_users, length))
    labels = np.where(live, actions, 0).astype(np.float32)
    newest = float(mix["t_start"]) + rng.uniform(0.0, float(mix["t_span"]), size=(n_users, 1))
    gaps = rng.exponential(float(mix["gap_mean_s"]), size=(n_users, length))
    gaps[:, 0] = 0.0
    stamps = np.where(live, newest - np.cumsum(gaps, axis=1), 0.0).astype(np.float32)
    u = int(mix["users"])
    return [{"product_ids": ids[i * u:(i + 1) * u].astype(np.int64),
             "labels": labels[i * u:(i + 1) * u],
             "timestamps": stamps[i * u:(i + 1) * u]} for i in range(int(mix["pool"]))]
