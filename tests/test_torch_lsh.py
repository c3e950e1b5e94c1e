"""The rest of the port's layer library against the JAX package's, on the CPU,
with JAX's variables converted (``convert.lsh_state_dict_from_jax``):
``SimhashVectorIndexer`` and ``QuantileMapper`` bit for bit, ``DenseMapper``,
``CosineLinear``, ``LearnableCosineVectorEmbedding`` and
``ProbabilityVectorEmbedding`` forwards at 2e-5 and their parameters'
gradients at 2e-4 (norm-relative, ``tests/test_fused_attention.py``'s
tolerances), ``_topk_sparsify`` with ties at the k-th value, the converter
refusing a missing or an extra key, ``cap_gradients`` against
``jax.vjp``, and the config methods ``LTHMModelConfig.export_span``,
``FeaturesConfig.get_features_map`` and ``get_transformers``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.features.feature_config import FeaturesConfig as JaxFeaturesConfig
from recommendations_tpu.config.yaml_loader import load_config as jax_load_config
from recommendations_tpu.nn import functional as jfn
from recommendations_tpu.nn import lsh as jlsh
from recommendations_tpu_torch.features.feature_config import FeaturesConfig
from recommendations_tpu_torch.config.yaml_loader import load_config
from recommendations_tpu_torch.models.lthm.convert import lsh_state_dict_from_jax
from recommendations_tpu_torch.nn import functional as tfn
from recommendations_tpu_torch.nn import lsh as tlsh

torch.set_num_threads(1)

F32_TOL = 2e-5   # float32 forwards
GRAD_TOL = 2e-4  # gradients, norm-relative


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, variables):
    module.load_state_dict(lsh_state_dict_from_jax(_np(variables), module), strict=True)
    return module


def _rel(a, b):
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30))


def _randn(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _check(jm, variables, tm, args, targs):
    """The forward at 2e-5 and every parameter's gradient of <out, g> at
    2e-4, JAX's (op by op) against the port's."""
    want = np.asarray(jm.apply(variables, *args))
    got = tm(*targs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    g = _randn(want.shape, 99)
    params = variables.get("params", {})
    if not params:
        return
    rest = {k: v for k, v in variables.items() if k != "params"}
    jg = jax.grad(lambda p: jnp.sum(jm.apply({"params": p, **rest}, *args) * g))(params)
    (got * torch.from_numpy(g)).sum().backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    want_g = {k: v for k, v in lsh_state_dict_from_jax({"params": _np(jg), **_np(rest)}, tm).items() if k in grads}
    assert set(grads) == set(want_g)
    for k, w in want_g.items():
        assert _rel(grads[k].numpy(), w.numpy()) <= GRAD_TOL, k


@pytest.mark.parametrize("inp_dim,n_proj", [(8, 10), (33, 16), (5, 63)])
def test_simhash_indexer_bit_exact(inp_dim, n_proj):
    """int64 codes with bit i from projection i, up to 63 bits."""
    x = _randn((7, 3, inp_dim), 1)
    jm = jlsh.SimhashVectorIndexer(inp_dim=inp_dim, n_proj=n_proj)
    vs = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    assert set(vs) == {"constants"}
    want = np.asarray(jm.apply(vs, jnp.asarray(x)))
    tm = _load(tlsh.SimhashVectorIndexer(inp_dim, _gen(), n_proj=n_proj), vs)
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.int64 and want.dtype == np.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1


def test_quantile_mapper_bit_exact():
    """Values on the quantiles (counted as below: ``b < x``), between them,
    and outside."""
    q = (-1.0, 0.0, 0.5, 2.0, 3.25)
    x = np.concatenate([np.asarray(q, np.float32), _randn((200,), 2, 2.0), [-1e9, 1e9]]).astype(np.float32)
    want = np.asarray(jlsh.QuantileMapper(quantiles=q).apply({}, jnp.asarray(x)))
    tm = tlsh.QuantileMapper(q)
    assert tm.state_dict() == {}
    np.testing.assert_array_equal(tm(torch.from_numpy(x)).numpy(), want)


def test_dense_mapper_matches_jax():
    """Three numeric features through their quantile mappers and two
    cosine-LSH embeddings (bf16 products): the sum at 2e-5 and the tables'
    gradients at 2e-4; the submodules keep JAX's names."""
    stats = {"price": (0.1, 0.5, 2.0), "age": (18.0, 30.0, 45.0, 60.0), "score": (-1.0, 1.0)}
    rs = np.random.RandomState(3)
    batch = {"price": rs.rand(40).astype(np.float32) * 3, "age": rs.randint(10, 80, 40).astype(np.float32),
             "score": rs.randn(40).astype(np.float32)}
    jm = jlsh.DenseMapper(stats=stats, features=12, n_projs=(8, 6), num_bins=(5, 9))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vs = jm.init(jax.random.PRNGKey(0), jb)
    tm = _load(tlsh.DenseMapper(stats, 12, (8, 6), (5, 9), _gen()), vs)
    assert {n for n, _ in tm.named_children()} == {"q_price", "q_age", "q_score", "emb_0", "emb_1"}
    _check(jm, vs, tm, (jb,), ({k: torch.from_numpy(v) for k, v in batch.items()},))


def test_cosine_linear_matches_jax():
    x = _randn((6, 4, 10), 4, 5.0)
    jm = jlsh.CosineLinear(out_dim=7)
    vs = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = _load(tlsh.CosineLinear(10, 7, _gen()), vs)
    _check(jm, vs, tm, (jnp.asarray(x),), (torch.from_numpy(x),))


@pytest.mark.parametrize("top_k", [None, 3, 50])
@pytest.mark.parametrize("shape", [(5, 8), (2, 3, 8)])
def test_learnable_cosine_vector_embedding_matches_jax(top_k, shape):
    """(batch, inp) and (batch, seq, inp) inputs, with and without top-k
    (50 is cut to num_bins)."""
    x = _randn(shape, 5)
    jm = jlsh.LearnableCosineVectorEmbedding(inp_dim=8, features=6, n_proj=4, num_bins=7,
                                             sigma_inflation_factor=1.5, top_k=top_k)
    vs = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tm = _load(tlsh.LearnableCosineVectorEmbedding(8, 6, _gen(), n_proj=4, num_bins=7, sigma_inflation_factor=1.5,
                                                   top_k=top_k), vs)
    assert set(tm.state_dict()) == {"proj.weight", "mean", "emb.weight"}
    _check(jm, vs, tm, (jnp.asarray(x),), (torch.from_numpy(x),))


@pytest.mark.parametrize("top_k", [None, 2])
def test_probability_vector_embedding_matches_jax(top_k):
    p = np.random.RandomState(6).rand(9, 1).astype(np.float32)
    jm = jlsh.ProbabilityVectorEmbedding(features=5, num_bins=6, top_k=top_k)
    vs = jm.init(jax.random.PRNGKey(3), jnp.asarray(p))
    tm = _load(tlsh.ProbabilityVectorEmbedding(5, _gen(), num_bins=6, top_k=top_k), vs)
    _check(jm, vs, tm, (jnp.asarray(p),), (torch.from_numpy(p),))
    with pytest.raises(ValueError):
        tm(torch.zeros(3, 2))


def test_topk_sparsify_keeps_ties_at_the_kth_value():
    act = np.array([[0.1, 0.5, 0.5, 0.5, 0.2], [0.9, 0.3, 0.3, 0.1, 0.3]], np.float32)
    want = np.asarray(jlsh._topk_sparsify(jnp.asarray(act), 2))
    got = tlsh._topk_sparsify(torch.from_numpy(act), 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] > 0).sum() == 3 and (got[1] > 0).sum() == 4


def test_lsh_converter_refuses_a_missing_or_an_extra_key():
    x = jnp.asarray(_randn((4, 8), 7))
    jm = jlsh.LearnableCosineVectorEmbedding(inp_dim=8, features=6, n_proj=4, num_bins=5)
    vs = _np(jm.init(jax.random.PRNGKey(0), x))
    tm = tlsh.LearnableCosineVectorEmbedding(8, 6, _gen(), n_proj=4, num_bins=5)
    missing = {"params": {k: v for k, v in vs["params"].items() if k != "mean"}}
    with pytest.raises(KeyError, match="mean"):
        lsh_state_dict_from_jax(missing, tm)
    extra = {"params": dict(vs["params"], stray=np.zeros(3, np.float32))}
    with pytest.raises(KeyError, match="stray"):
        lsh_state_dict_from_jax(extra, tm)
    with pytest.raises(KeyError, match="batch_stats"):
        lsh_state_dict_from_jax(dict(vs, batch_stats={}), tm)
    sv = _np(jlsh.SimhashVectorIndexer(inp_dim=8, n_proj=4).init(jax.random.PRNGKey(0), x))
    with pytest.raises(KeyError, match="projection_mat"):
        lsh_state_dict_from_jax({"params": {}}, tlsh.SimhashVectorIndexer(8, _gen(), n_proj=4))
    assert set(lsh_state_dict_from_jax(sv, tlsh.SimhashVectorIndexer(8, _gen(), n_proj=4))) == {"projection_mat"}


@pytest.mark.parametrize("shape", [(6,), (3, 5), (2, 3, 4)])
def test_cap_gradients_vjp_matches_jax(shape):
    """The identity forward; the cotangent divided by its norm over the
    whole tensor, and a zero cotangent stays zero."""
    x, g = _randn(shape, 8), _randn(shape, 9, 3.0)
    out, vjp = jax.vjp(jfn.cap_gradients, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    got = tfn.cap_gradients(xt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    xt.grad = None
    tfn.cap_gradients(xt).backward(torch.zeros(shape))
    assert not xt.grad.any()


def test_export_span_as_jax():
    """lthm_tiny.yaml's model with its own lookahead and two others."""
    import dataclasses

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
    jm = jax_load_config(os.path.join(root, "lthm_tiny.yaml"), search_paths=[root]).model
    tm = load_config(os.path.join(root, "lthm_tiny.yaml"), search_paths=[root]).model
    assert tm.export_span == jm.export_span == max(jm.lookahead) + 1
    for lookahead in ([0], [7, 2]):
        jc = jm.model_copy(update={"lookahead": lookahead})
        assert dataclasses.replace(tm, lookahead=lookahead).export_span == jc.export_span == max(lookahead) + 1


def test_features_map_and_transformers_as_jax():
    """The same features by name (kind and source column) and the same
    transforms, in order, by function and keywords."""
    d = {
        "defaults": {"categorical_features": {"default_dtype": "string", "value_to_number_mapper": {"kind": "xxhash"}}},
        "categorical_features": [{"name": "product_id", "kind": "categorical"},
                                 {"name": "brand", "kind": "categorical", "transform_value_to_lowercase": True}],
        "numerical_features": [{"name": "price", "kind": "numerical"}],
        "bool_features": [{"name": "is_new", "kind": "bool"}],
        "lat_lng_features": [{"name": "geo", "kind": "latlong"}],
    }
    import copy

    jc, tc = JaxFeaturesConfig(**copy.deepcopy(d)), FeaturesConfig.from_dict(copy.deepcopy(d))
    jmap, tmap = jc.get_features_map(), tc.get_features_map()
    assert list(tmap) == list(jmap) and tmap
    for name, f in jmap.items():
        assert tmap[name].kind.value == f.kind.value and tmap[name].source.input_field == f.source.input_field

    def described(transformers):
        return [(t.func.__name__, dict(t.keywords)) if hasattr(t, "func") else (t.__name__, {})
                for t in transformers]

    assert described(tc.get_transformers()) == described(jc.get_transformers())
    assert tc.get_transformers() is tc.transformers
