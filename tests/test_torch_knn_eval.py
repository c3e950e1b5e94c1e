"""The port's KNN retrieval eval against the JAX package's, on the CPU, with
the same weights (``load_jax_variables``) and numpy-seeded inputs:

- the chunked catalog (a running top-k merge over chunks of 100, the last
  one padded) equals the one-shot catalog, row for row;
- ``knn_recall``'s hits and query counts equal JAX's (exact; at f32 the
  query and catalog embeddings agree within 2e-5, and no score lies within
  that of a top-k boundary on these inputs);
- ``encode_catalog`` within 2e-5 of JAX's (f32), on a fresh table and on
  the pretrained module;
- catalog ids read from parquet are hashed as the history feature (the
  same int64s as JAX's), and an int64 column passes through;
- ``run_knn_eval`` through the pipeline config: the fallback catalog (the
  eval stream's ids) and ``skip_knn_eval``.

The catalog comparisons run JAX op by op (``jax.disable_jit()``): compiled
on the CPU, XLA drops the bf16 rounding of the LSH embedding's one-hot
product in the catalog encoder, which moves its f32 embeddings by up to
1.7e-3. ``test_compiled_jax_catalog_differs_from_the_port_only_by_the_lsh_rounding``
holds the port to compiled JAX stage by stage and shows that rounding to be
the whole of the difference; the queries are held to the compiled forward.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from recommendations_tpu.models.lthm.config import LTHMModelConfig as JaxConfig
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxWrapper
from recommendations_tpu.pipeline import knn_eval as jknn
from recommendations_tpu_torch.data.data_store import FakeDataStore
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.pipeline import knn_eval as tknn

F32_TOL = 2e-5
TOP_K = [1, 5, 20]


def tiny_config() -> dict:
    """tests/test_knn_eval.py's _tiny_wrapper, as a dict both packages take."""
    return dict(
        features={"defaults": {}},
        transformer_config=dict(
            rotator_config={"ff_mult": 2}, is_causal=True, num_layers=1,
            attn_config=dict(n_head=2, n_embd=32, attn_type="multi_query", dropout=0.0, attn_dropout=0.0,
                             bias=False),
        ),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=32, product_emb_dim=16, norm_bins=4,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 8}],
            latent_model_config={"vocab_size_latent": 1024, "num_shifts_latent": 4, "normalize_embedding": True},
        ),
        log_q_config={"num_buckets": 1024, "hash_offsets": [0]},
        lookahead=[0],
        context_width=8,
        train_mini_batch_size=-1,
        compute_dtype="float32",
    )


def user_batch(seed=0, b=8, s=10):
    rs = np.random.RandomState(seed)
    ids = rs.randint(-(2**62), 2**62, size=(b, s)).astype(np.int64)
    ids[:, -2:] = 0
    ids[3, 1:] = 0  # one real event: not a query
    return {
        "product_ids": ids,
        "labels": rs.randint(0, 4, size=(b, s)).astype(np.float32),
        "timestamps": rs.randint(1_600_000_000, 1_700_000_000, size=(b, s)).astype(np.float32),
    }


def pair(d=None):
    d = d or tiny_config()
    jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
    vs = jw.init_variables(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in user_batch().items()})
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
    tw.load_jax_variables(jax.tree_util.tree_map(np.asarray, vs))
    return jw, vs, tw


@pytest.fixture(scope="module")
def models():
    return pair()


def catalog_for(batches, seed=0, extra=500):
    rs = np.random.RandomState(seed)
    ids = np.concatenate([b["product_ids"].reshape(-1) for b in batches] + [rs.randint(-(2**62), 2**62, extra)])
    cat = np.unique(ids).astype(np.int64)
    return cat[cat != 0]


def test_chunked_catalog_equals_single_shot(models):
    _, _, tw = models
    batches = [user_batch(0), user_batch(1)]
    catalog = catalog_for(batches)
    chunked = tknn.knn_recall(tw, batches, catalog, TOP_K, catalog_chunk_rows=100)
    single = tknn.knn_recall(tw, batches, catalog, TOP_K, catalog_chunk_rows=len(catalog))
    assert chunked == single
    assert all(r["queries"] == 14 for r in chunked)  # two rows of one real event left out
    rec = [r["recall"] for r in chunked]
    assert rec == sorted(rec)
    # the merged top-k itself, row for row, against one full product
    emb = tknn.encode_catalog(tw, catalog)
    qe, _, _ = tknn.knn_query(tw, batches[0])
    v_c, ids_c = tknn.chunked_topk(qe, tknn._catalog_chunks(emb, catalog, 100, tw.device), 20)
    v_1, idx_1 = (qe @ torch.from_numpy(emb).T).topk(20, dim=1)
    np.testing.assert_array_equal(v_c.numpy(), v_1.numpy())
    # the ids where the score is not tied (a masked product scores exactly 0)
    v = v_1.numpy()
    untied = (np.diff(v, axis=1, prepend=np.inf) != 0) & (np.diff(v, axis=1, append=-np.inf) != 0)
    np.testing.assert_array_equal(ids_c.numpy()[untied], catalog[idx_1.numpy()][untied])
    assert untied.mean() > 0.5


def test_encode_catalog_matches_jax(models):
    jw, vs, tw = models
    catalog = catalog_for([user_batch(0)], extra=300)
    with jax.disable_jit():
        want = jknn.encode_catalog(jw, vs, catalog, batch_size=64)
    got = tknn.encode_catalog(tw, catalog, batch_size=64)
    assert got.shape == want.shape == (len(catalog), 16)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=F32_TOL)


def bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16).float().numpy()


def compiled_jax_product_stages(jw, vs, ids: np.ndarray) -> dict:
    """Each stage of JAX's catalog encoder (``pipeline/knn_eval.py``'s
    product path on a fresh KShift table), compiled as ``encode_catalog``
    compiles it: the three terms of the sum before ``product_mapper``, the
    mask and ``product_mapper``'s kernel."""
    import flax.linen as nn

    from recommendations_tpu.models.lthm.model import ProductTower
    from recommendations_tpu.nn.embeddings import KShiftEmbedding

    cfg = jw.config
    tc = cfg.product_tower

    class Encoder(nn.Module):
        @nn.compact
        def __call__(self, x):
            embs = KShiftEmbedding(num_embeddings=tc.latent_model_config.vocab_size_latent, features=tc.inp_emb_dim,
                                   num_shifts=tc.latent_model_config.num_shifts_latent,
                                   normalize_output=tc.latent_model_config.normalize_embedding,
                                   fused_record=cfg.uses_fused_table(), name="product_emb_module")(x)
            return ProductTower(cfg, name="product_tower")(x, embs)

    sub = {c: {k: v for k, v in vs[c].items() if k in ("product_emb_module", "product_tower")}
           for c in ("params", "constants") if c in vs}
    (_, _, mask), inter = jax.jit(
        lambda x: Encoder().apply(sub, x, capture_intermediates=True, mutable=["intermediates"]))(jnp.asarray(ids))
    tower = inter["intermediates"]["product_tower"]
    out = {n: np.asarray(tower[n]["__call__"][0]) for n in ("emb_mapper", "direction_emb_0", "norm_emb")}
    out.update(mask=np.asarray(mask),
               product_mapper=np.asarray(sub["params"]["product_tower"]["product_mapper"]["kernel"]))
    return out


def test_compiled_jax_catalog_differs_from_the_port_only_by_the_lsh_rounding(models):
    """Compiled on the CPU, XLA computes the LSH embedding's one-hot product
    (``nn/lsh.py:119``, in bf16: ``ProductTower`` gives
    ``CosineVectorEmbedding`` no dtype) as an f32 product of the bf16 table
    rows, without the product's bf16 output rounding: the sum of a product's
    n_proj rows stays in f32. Op by op, and in the port, that sum is rounded
    to bf16. This is the whole of the drift between compiled JAX's catalog
    embeddings and the port's: the other stages agree within 2e-5, the
    port's LSH sums are compiled JAX's rounded to bf16, bit for bit, and
    compiled JAX's product path finished from those rounded sums gives the
    port's catalog within 2e-5. (In the compiled LTHM forward XLA keeps the
    rounding: ``test_knn_recall_matches_jax`` holds the port's queries to
    compiled JAX's.)"""
    jw, vs, tw = models
    catalog = catalog_for([user_batch(0)], extra=300)
    want = compiled_jax_product_stages(jw, vs, catalog)
    seen = {}
    tower = tw.module.product_tower
    hooks = [getattr(tower, n).register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, o.detach().float().numpy()))
        for n in ("emb_mapper", "direction_emb_0", "norm_emb")]
    try:
        got = tknn.encode_catalog(tw, catalog, batch_size=len(catalog))
    finally:
        for h in hooks:
            h.remove()
    for n in ("emb_mapper", "norm_emb"):
        np.testing.assert_allclose(seen[n], want[n], rtol=0, atol=F32_TOL, err_msg=n)
    np.testing.assert_array_equal(seen["direction_emb_0"], bf16(want["direction_emb_0"]))
    emb = want["emb_mapper"] + bf16(want["direction_emb_0"]) + want["norm_emb"]
    prod = np.where(want["mask"][:, None], 0.0, emb) @ want["product_mapper"]
    prod = prod / np.maximum(np.linalg.norm(prod, axis=-1, keepdims=True), 1e-12)
    np.testing.assert_allclose(got, prod, rtol=0, atol=F32_TOL)


def test_knn_recall_matches_jax(models):
    jw, vs, tw = models
    batches = [user_batch(0), user_batch(2)]
    catalog = catalog_for(batches, seed=3)
    with jax.disable_jit():
        want = jknn.knn_recall(jw, vs, batches, catalog, TOP_K, catalog_chunk_rows=128)
    got = tknn.knn_recall(tw, batches, catalog, TOP_K, catalog_chunk_rows=128)
    assert [r["k"] for r in got] == list(want["k"])
    assert [r["queries"] for r in got] == list(want["queries"])
    assert [r["recall"] for r in got] == list(want["recall"])
    # the queries and labels themselves, against the compiled JAX forward
    qe, label, count = tknn.knn_query(tw, batches[0])
    out = jax.jit(jw.forward)(vs, {k: jnp.asarray(v) for k, v in batches[0].items()})
    s = out["current_token_mask"].shape[1]
    jq = np.asarray(out["next_token_emb"][:, s - 1, 0, :])
    jq = jq / np.maximum(np.linalg.norm(jq, axis=-1, keepdims=True), 1e-12)
    np.testing.assert_allclose(qe.numpy(), jq, rtol=0, atol=F32_TOL)
    np.testing.assert_array_equal(label.numpy(), np.asarray(out["current_token_ids"][:, s - 1]))
    np.testing.assert_array_equal(count.numpy(), np.asarray((~out["current_token_mask"]).sum(1)))


def test_encode_catalog_pretrained_matches_jax(tmp_path):
    from recommendations_tpu.tools import embedding_module_gen as jgen
    from recommendations_tpu_torch.tools import embedding_module_gen as tgen

    rs = np.random.RandomState(0)
    df = pd.DataFrame({"product_id": [f"p{i}" for i in range(64)],
                       "emb_128": list(rs.randn(64, 16).astype(np.float32))})
    ids, embs = jgen.massage_embeddings(df, dim=16)
    art = jgen.train_reconstruction(ids, embs, 2.0, 4, num_epochs=2, batch_size=64)
    art.update(jgen.train_mask_model(ids, 2.0, num_epochs=1, batch_size=64))
    jgen.save_artifact(art, str(tmp_path), {"dim": 16})
    tgen.save_artifact(jax.tree_util.tree_map(np.asarray, art), str(tmp_path))
    d = tiny_config()
    d["product_tower"]["model_init_metadata"] = {"embedding_module_path": str(tmp_path)}
    d["product_tower"]["latent_model_config"] = {"vocab_size_latent": 128, "num_shifts_latent": 4,
                                                 "normalize_embedding": True}
    jw, vs, tw = pair(d)
    assert "constants" in vs
    with jax.disable_jit():
        want = jknn.encode_catalog(jw, vs, ids[:40], batch_size=16)
    got = tknn.encode_catalog(tw, ids[:40], batch_size=16)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=F32_TOL)


class _Cfg:
    """A duck-typed pipeline config for the catalog reader (the JAX test's)."""

    def __init__(self, path, fs):
        self.eval = type("E", (), {"knn_catalog_table_path": path, "knn_catalog_id_column": None})()
        self.dataset = type("D", (), {"filesystem_config": fs})()
        feat = type("F", (), {"history_id_feature_name": "product_id"})()
        feats = type("Fs", (), {"categorical_history_features": [feat]})()
        self.model = type("M", (), {"features": feats})()


def test_catalog_ids_hash_as_the_history_feature():
    from recommendations_tpu.config.trainer_config import FileSystemConfig as JaxFs
    from recommendations_tpu.data import FakeDataStore as JaxFake
    from recommendations_tpu_torch.config.trainer_config import FileSystemConfig
    from recommendations_tpu_torch.features.transforms import objects

    skus = [f"sku_{i}" for i in range(50)] + ["sku_3", "sku_7"]
    JaxFake.reset()
    FakeDataStore.reset()
    try:
        JaxFake.put_table("catalog/products.parquet", pd.DataFrame({"product_id": skus}))
        FakeDataStore.put_table("catalog/products.parquet", {"product_id": objects(skus)})
        want = jknn._load_catalog_ids(_Cfg("catalog/products.parquet", JaxFs(kind="fake", path_template="catalog")))
        got = tknn.load_catalog_ids(_Cfg("catalog/products.parquet",
                                         FileSystemConfig(kind="fake", path_template="catalog")))
        assert got.dtype == np.int64 and len(got) == 50
        np.testing.assert_array_equal(got, want)
        FakeDataStore.put_table("catalog/hashed.parquet", {"product_id": np.array([5, -9, 5, 0], np.int64)})
        got2 = tknn.load_catalog_ids(_Cfg("catalog/hashed.parquet",
                                          FileSystemConfig(kind="fake", path_template="catalog")))
        np.testing.assert_array_equal(got2, np.array([-9, 5], np.int64))
    finally:
        JaxFake.reset()
        FakeDataStore.reset()


def test_run_knn_eval_from_the_pipeline_config(tmp_path):
    """lthm_tiny.yaml from the in-memory store: the eval stream's own ids as
    the catalog when no table is named; ``skip_knn_eval`` gives None."""
    from recommendations_tpu_torch.config.yaml_loader import load_config, parse_cli_overrides
    from recommendations_tpu_torch.tools.synth_data import write_synthetic_dataset
    from tests.test_torch_config_loader import CONFIG_ROOT

    FakeDataStore.reset()
    try:
        write_synthetic_dataset(None, ["20240102"], files_per_date=1, users_per_file=40, history_len=64,
                                fake_store=True)
        cfg = load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=parse_cli_overrides(
            ["dataset.filesystem_config.kind=fake", "eval.skip_knn_eval=false", "eval.max_eval_steps=1",
             "model.compute_dtype=float32"]), search_paths=[str(CONFIG_ROOT)])
        tw = LTHMModelWrapper(cfg.model, device="cpu")
        rows = tknn.run_knn_eval(tw, cfg)
        assert [r["k"] for r in rows] == cfg.eval.knn_top_k_list
        assert rows[0]["queries"] > 0 and all(0.0 <= r["recall"] <= 1.0 for r in rows)
        cfg.eval.skip_knn_eval = True
        assert tknn.run_knn_eval(tw, cfg) is None
    finally:
        FakeDataStore.reset()
