"""Port layers (recommendations_tpu_torch.nn) against the JAX package's, on
the CPU: the int64 hashes bit for bit, the embedding and LSH layers with the
same weights, and the stateless ops."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.nn import embeddings as jemb
from recommendations_tpu.nn import functional as jfn
from recommendations_tpu.nn import lsh as jlsh
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.nn import embeddings as temb
from recommendations_tpu_torch.nn import functional as tfn
from recommendations_tpu_torch.nn import lsh as tlsh

torch.set_num_threads(1)

INT64_MIN, INT64_MAX = -(2**63), 2**63 - 1


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _load(module, variables):
    """JAX variables -> the torch module, through the port's converter."""
    module.load_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables), module)
    )
    return module


def _edge_ids(seed=0, n=4008):
    rs = np.random.RandomState(seed)
    rand = rs.randint(INT64_MIN, INT64_MAX, size=n, dtype=np.int64)
    edges = np.array([0, 1, -1, 2, -2, INT64_MIN, INT64_MAX, INT64_MIN + 1, INT64_MAX - 1], np.int64)
    return np.concatenate([edges, rand]).reshape(-1, 13)


@pytest.mark.parametrize("num_embeddings", [1_000_000, 2**20, 3, 2**31 - 1, 2**61 + 1])
def test_kshift_row_indices_bit_exact(num_embeddings):
    ids = _edge_ids()
    want = np.asarray(jemb.kshift_row_indices(jnp.asarray(ids), num_embeddings, 8))
    got = temb.kshift_row_indices(torch.from_numpy(ids), num_embeddings, 8).numpy()
    assert got.dtype == np.int64 and got.shape == ids.shape + (8,)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < num_embeddings


def test_kshift_row_indices_rejects_float_ids():
    with pytest.raises(TypeError):
        temb.kshift_row_indices(torch.zeros(3), 10, 2)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("num_embeddings", [4, 37, 5000])
def test_flat_embedding_negative_ids(compute_dtype, num_embeddings):
    """Rows of the full-range ids, bf16-rounded as the one-hot lookup rounds
    them up to 4096 rows, exact above."""
    ids = _edge_ids(1)[:20]
    cd_j = None if compute_dtype is None else jnp.bfloat16
    cd_t = None if compute_dtype is None else torch.bfloat16
    jm = jemb.FlatEmbedding(num_embeddings, 8, compute_dtype=cd_j)
    vs = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))
    want = np.asarray(jm.apply(vs, jnp.asarray(ids)))
    tm = _load(temb.FlatEmbedding(num_embeddings, 8, _gen(), compute_dtype=cd_t), vs)
    np.testing.assert_array_equal(tm(torch.from_numpy(ids)).detach().numpy(), want)


@pytest.mark.parametrize("as_float", [False, True])
def test_pattern_from_timelocal_negative_times(as_float):
    rs = np.random.RandomState(2)
    t = rs.randint(-2_000_000_000, 2_000_000_000, size=(6, 9)).astype(np.int64)
    t[0, :4] = [-1, -3600, -3601, 0]
    if as_float:
        t = t.astype(np.float32)
    for div, mod in ((3600, 24), (3600, 168), (86400, 7)):
        idx_j = jemb.PatternFromTimelocal(div, mod, 0).apply({}, jnp.asarray(t))
        idx_t = temb.PatternFromTimelocal(div, mod, 0, _gen())(torch.from_numpy(t))
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        jm = jemb.PatternFromTimelocal(div, mod, 8, compute_dtype=jnp.bfloat16)
        vs = jm.init(jax.random.PRNGKey(1), jnp.asarray(t))
        tm = _load(temb.PatternFromTimelocal(div, mod, 8, _gen(), compute_dtype=torch.bfloat16), vs)
        np.testing.assert_array_equal(
            tm(torch.from_numpy(t)).detach().numpy(), np.asarray(jm.apply(vs, jnp.asarray(t)))
        )


def test_histogram_embedding():
    x = np.array([[-0.5, 0.0, 0.049, 0.05, 0.5, 0.999, 1.0, 1.7, np.float32(0.35)]], np.float32)
    jm = jemb.HistogramEmbedding(0.0, 1.0, 20, 8, compute_dtype=jnp.bfloat16)
    vs = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tm = _load(temb.HistogramEmbedding(0.0, 1.0, 20, 8, _gen(), compute_dtype=torch.bfloat16), vs)
    np.testing.assert_array_equal(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(jm.apply(vs, jnp.asarray(x))))


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("normalize", [False, True])
def test_kshift_embedding(compute_dtype, normalize):
    ids = _edge_ids(3)[:40]
    cd_j = None if compute_dtype is None else jnp.bfloat16
    cd_t = None if compute_dtype is None else torch.bfloat16
    jm = jemb.KShiftEmbedding(5000, 16, num_shifts=8, normalize_output=normalize, compute_dtype=cd_j)
    vs = jm.init(jax.random.PRNGKey(3), jnp.asarray(ids))
    want = np.asarray(jm.apply(vs, jnp.asarray(ids)))
    tm = _load(
        temb.KShiftEmbedding(5000, 16, _gen(), num_shifts=8, normalize_output=normalize, compute_dtype=cd_t),
        vs,
    )
    got = tm(torch.from_numpy(ids)).detach().numpy()
    assert got.dtype == np.float32
    # f32 sums of the same 8 rows in another order: float32 rounding only
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("n_proj,num_bins", [(32, 2), (32, 12), (16, 20)])
def test_cosine_vector_embedding(n_proj, num_bins):
    rs = np.random.RandomState(4)
    x = rs.randn(5, 30, 16).astype(np.float32)
    x[0, 0] = 0.0  # an exact-zero row
    jm = jlsh.CosineVectorEmbedding(16, 24, n_proj=n_proj, num_bins=num_bins)
    vs = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    want = np.asarray(jm.apply(vs, jnp.asarray(x)))
    tm = _load(tlsh.CosineVectorEmbedding(16, 24, _gen(), n_proj=n_proj, num_bins=num_bins), vs)
    # bucket boundaries identical, buckets identical
    resolution = 2.0 / float(num_bins)
    grid_j = (jnp.linspace(-1.0, 1.0, num_bins + 1)[:-1] + 0.5 * resolution).astype(jnp.float32)
    np.testing.assert_array_equal(tm.grid.numpy(), np.asarray(grid_j))
    proj = vs["constants"]["projection_mat"]
    z = jfn.l2_normalize(jnp.asarray(x)) @ proj
    want_b = np.asarray(jlsh._bucketize(z, grid_j))
    np.testing.assert_array_equal(tm.buckets(torch.from_numpy(x)).numpy(), want_b)
    got = tm(torch.from_numpy(x)).detach().numpy()
    # bf16 rows summed with f32 accumulation, one rounding to bf16: one bf16
    # ulp where the two sums round to neighbouring values
    np.testing.assert_allclose(got, want, rtol=2**-8, atol=1e-6)


def test_l2_normalize_and_activations():
    rs = np.random.RandomState(6)
    x = rs.randn(7, 33).astype(np.float32)
    x[3] = 0.0
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tfn.l2_normalize(xt).numpy(), np.asarray(jfn.l2_normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tfn.l2_normalize(xt, dim=0).numpy(), np.asarray(jfn.l2_normalize(jnp.asarray(x), axis=0)), rtol=1e-6, atol=1e-7
    )
    assert np.all(tfn.l2_normalize(xt).numpy()[3] == 0.0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = tfn.l2_normalize_f32acc(xt.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jfn.l2_normalize_f32acc(xb)).astype(np.float32))
    np.testing.assert_allclose(tfn.gelu_tanh(xt).numpy(), np.asarray(jfn.gelu_tanh(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tfn.quick_gelu(xt).numpy(), np.asarray(jfn.quick_gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)
