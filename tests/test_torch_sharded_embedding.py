"""The port's row-sharded table (``parallel/sharded_embedding.py``) on gloo
worker processes against the JAX package's on its virtual CPU mesh of the
same shape: both schedules (psum and alltoall) at ``model`` = 2 and 4,
forward and table gradient, the plain lookup, heavy duplicates, the
normalized KShift, and the all-to-all's overflow count (equal to JAX's) at
a capacity small enough to drop rows. Float32 forwards within 2e-5, the
table gradients within 2e-4 (ROADMAP's tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from recommendations_tpu.core.mesh import MeshConfig, build_mesh
from recommendations_tpu.nn.embeddings import kshift_row_indices
from recommendations_tpu.parallel import sharded_embedding as jse
from torch_dist import start_workers

WORLD = 4
FWD_TOL = 2e-5
GRAD_TOL = 2e-4


def _ids(n, seed, width=6):
    return np.random.RandomState(seed).randint(-(2**62), 2**62, size=(n, width), dtype=np.int64)


def _table(rows, d, seed):
    return np.random.RandomState(seed).randn(rows, d).astype(np.float32)


def _dup_ids():
    rs = np.random.RandomState(0)
    pool = rs.randint(-(2**62), 2**62, size=5, dtype=np.int64)
    return pool[rs.randint(0, 5, size=(16, 12))]  # 5 distinct ids in the whole batch


# name: (model, schedule, table, ids, num_shifts, with a gradient, capacity_factor, normalize)
CASES = {
    "kshift_psum_m2": (2, "psum", _table(1024, 32, 0), _ids(16, 3), 5, True, 2.0, False),
    "kshift_psum_m4": (4, "psum", _table(1024, 32, 0), _ids(16, 3), 5, True, 2.0, False),
    "kshift_alltoall_m2": (2, "alltoall", _table(1024, 32, 0), _ids(16, 3), 5, True, 2.0, False),
    "kshift_alltoall_m4": (4, "alltoall", _table(1024, 32, 0), _ids(16, 3), 5, True, 2.0, False),
    "duplicates_alltoall_m4": (4, "alltoall", _table(512, 16, 2), _dup_ids(), 4, True, 2.0, False),
    "duplicates_psum_m2": (2, "psum", _table(512, 16, 2), _dup_ids(), 4, True, 2.0, False),
    "normalized_psum_m2": (2, "psum", _table(512, 16, 4), _ids(8, 5), 4, True, 2.0, True),
    "normalized_alltoall_m4": (4, "alltoall", _table(512, 16, 4), _ids(8, 5), 4, True, 2.0, True),
    "plain_psum_m4": (4, "psum", _table(640, 8, 1), _ids(8, 3), None, False, 2.0, False),
    "plain_alltoall_m4": (4, "alltoall", _table(640, 8, 1), _ids(8, 3), None, False, 2.0, False),
    "overflow_low_m4": (4, "alltoall", _table(1024, 16, 0), _ids(256, 11), 5, False, 0.05, False),
    "overflow_ok_m4": (4, "alltoall", _table(1024, 16, 0), _ids(256, 11), 5, False, 2.0, False),
    "overflow_low_m2": (2, "alltoall", _table(1024, 16, 0), _ids(256, 11), 5, False, 0.05, False),
}


def _target(name):
    table, ids = CASES[name][2], CASES[name][3]
    return np.random.RandomState(9).randn(*ids.shape, table.shape[1]).astype(np.float32)


def _jax(name):
    """JAX's output, table gradient and overflow on 4 devices, data x model."""
    model, schedule, table, ids, k, with_grad, cf, normalize = CASES[name]
    mesh = build_mesh(MeshConfig(data=WORLD // model, model=model), devices=jax.devices()[:WORLD])
    st = jax.device_put(jnp.asarray(table), NamedSharding(mesh, P("model", None)))
    si = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P("data", None)))

    def lookup(t):
        if k is None:
            if schedule == "psum":
                return jse.sharded_embedding_lookup(t, si, mesh), None
            return jse.alltoall_embedding_lookup(t, si, mesh, capacity_factor=cf, return_overflow=True)
        if schedule == "psum":
            return jse.sharded_kshift_lookup(t, si, mesh, k, normalize_output=normalize), None
        return jse.alltoall_kshift_lookup(t, si, mesh, k, normalize_output=normalize, capacity_factor=cf,
                                          return_overflow=True)

    out, overflow = jax.jit(lookup)(st)
    grad = None
    if with_grad:
        target = jnp.asarray(_target(name))
        grad = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum((lookup(t)[0] - target) ** 2)))(st))
    return {"out": np.asarray(out), "grad": grad, "overflow": None if overflow is None else float(overflow)}


@pytest.fixture(scope="module")
def results():
    jobs = []
    for name, (model, schedule, table, ids, k, with_grad, cf, normalize) in CASES.items():
        jobs.append((name, "lookup", dict(model=model, schedule=schedule, table=table, ids=ids, num_shifts=k,
                                          target=_target(name) if with_grad else None, capacity_factor=cf,
                                          normalize=normalize)))
    workers = start_workers(jobs, WORLD, timeout=150)
    want = {name: _jax(name) for name in CASES}
    ranks = workers.results()
    got = {}
    for name, (model, *_) in CASES.items():
        res = [r[name] for r in ranks]
        data = WORLD // model
        by = {(x["coords"]["data"], x["coords"]["model"]): x for x in res}
        # the output is the same on every rank of a model group
        for d in range(data):
            for m in range(1, model):
                np.testing.assert_array_equal(by[(d, m)]["out"], by[(d, 0)]["out"])
        out = np.concatenate([by[(d, 0)]["out"] for d in range(data)])
        grad = None
        if res[0]["grad"] is not None:
            grad = np.concatenate([sum(by[(d, m)]["grad"] for d in range(data)) for m in range(model)])
        overflows = {x["overflow"] for x in res}
        assert len(overflows) == 1, overflows  # the global count, on every rank
        got[name] = {"out": out, "grad": grad, "overflow": overflows.pop()}
    return got, want


@pytest.mark.parametrize("name", sorted(n for n in CASES if not n.startswith("overflow")))
def test_lookup_matches_jax(results, name):
    got, want = results
    np.testing.assert_allclose(got[name]["out"], want[name]["out"], rtol=FWD_TOL, atol=FWD_TOL)
    model, schedule, table, ids, k, *_ = CASES[name]
    if k is not None and not CASES[name][7]:
        dense = table[np.asarray(kshift_row_indices(jnp.asarray(ids), table.shape[0], k))].sum(-2) / np.sqrt(k)
        np.testing.assert_allclose(got[name]["out"], dense, rtol=FWD_TOL, atol=FWD_TOL)
    if CASES[name][5]:
        np.testing.assert_allclose(got[name]["grad"], want[name]["grad"], rtol=GRAD_TOL, atol=GRAD_TOL)
    if schedule == "alltoall":
        assert got[name]["overflow"] == want[name]["overflow"] == 0.0


@pytest.mark.parametrize("name", ["overflow_low_m4", "overflow_low_m2"])
def test_overflow_count_equals_jax(results, name):
    """At capacity factor 0.05 rows are dropped: the global count is JAX's,
    and the dropped requests come back as the same zero rows."""
    got, want = results
    assert got[name]["overflow"] == want[name]["overflow"] > 0
    np.testing.assert_allclose(got[name]["out"], want[name]["out"], rtol=FWD_TOL, atol=FWD_TOL)
    assert not np.allclose(got[name]["out"], got["overflow_ok_m4"]["out"])


def test_capacity_rule_matches_jax():
    from recommendations_tpu_torch.parallel.sharded_embedding import resolve_capacity

    for n, shards, cf in ((1000, 8, 2.0), (1536, 4, 0.05), (7, 2, 2.0), (300000, 2, 1.5)):
        assert resolve_capacity(n, shards, cf) == jse.resolve_capacity(n, shards, cf)
