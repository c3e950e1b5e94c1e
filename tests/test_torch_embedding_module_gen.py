"""The port's KShift compression job and pretrained product-embedding module
against the JAX package's, on the CPU.

- ``massage_embeddings``: the same hashed ids and embeddings;
- ``train_reconstruction`` and ``train_mask_model``: a few epochs from JAX's
  initial parameters (passed in) and the same numpy seeds (batch orders and
  negative ids) give JAX's tables and final losses within 1e-5 (f32; XLA and
  torch may round a fused sum differently, and Adagrad carries that through
  a dozen steps); the mask model's weights within 1e-3, and 99% of them
  within 1e-4: where a row's summed g**2 is below Adagrad's eps (1e-7) its
  step is lr * g / sqrt(1e-7), about 1581 g, so a last-bit difference of
  1e-7 in a gradient's sum over the batch moves the row by 1.6e-4 a step
  (the final loss within 1e-4 of JAX's, relative);
  ``torch.optim.Adagrad`` from the same start does not come close;
- the artifact round trip, and ``PretrainedProductEmbedding`` loaded with a
  JAX Orbax artifact equals JAX's module (f32 within 2e-5; bf16 within one
  bf16 step of the output's scale);
- an LTHM with ``model_init_metadata``: the forward within 2e-5 of JAX's
  (f32), the buffers take no gradient and a training step leaves them as
  they were.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommendations_tpu.models.lthm.config import LTHMModelConfig as JaxConfig
from recommendations_tpu.models.lthm.pretrained import PretrainedProductEmbedding as JaxPretrained
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxWrapper
from recommendations_tpu.nn.embeddings import KShiftEmbedding as JaxKShift
from recommendations_tpu.nn.embeddings import kshift_row_indices as jax_kshift_rows
from recommendations_tpu.nn.functional import l2_normalize as jax_l2
from recommendations_tpu.nn.functional import quick_gelu as jax_quick_gelu
from recommendations_tpu.tools import embedding_module_gen as jgen
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.pretrained import PretrainedProductEmbedding, load_pretrained_constants
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.tools import embedding_module_gen as tgen
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState
from tests.test_torch_lthm import small_batch, small_config

JOB_TOL = 1e-5
MASK_TOL, MASK_MOST_TOL = 1e-3, 1e-4
F32_TOL = 2e-5
N, DIM, EXPANSION, K = 200, 8, 4.0, 8


def _frame(n=N, seed=0):
    import pandas as pd

    rs = np.random.RandomState(seed)
    return pd.DataFrame({"product_id": [f"sku_{i}" for i in range(n)],
                         "emb_128": [rs.randn(128).astype(np.float32) for _ in range(n)]})


def _table(df):
    """The port's table of numpy columns for the same frame."""
    from recommendations_tpu_torch.features.transforms import objects

    return {"product_id": objects(df["product_id"]), "emb_128": objects(df["emb_128"])}


@pytest.fixture(scope="module")
def data():
    df = _frame()
    jids, jembs = jgen.massage_embeddings(df, dim=DIM)
    tids, tembs = tgen.massage_embeddings(_table(df), dim=DIM)
    return df, jids, jembs, tids, tembs


def test_massage_embeddings_hash_as_jax(data):
    _, jids, jembs, tids, tembs = data
    assert tids.dtype == np.int64
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tembs, jembs)


def _jax_recon_init(ids, seed=0):
    model = JaxKShift(num_embeddings=int(EXPANSION * len(ids)), features=DIM, num_shifts=K, normalize_output=True)
    return np.asarray(model.init(jax.random.PRNGKey(seed), jnp.asarray(ids[:2]))["params"]["embedding"])


def _recon_loss(table, ids, embs):
    """JAX's reconstruction loss of ``table`` over every id."""
    model = JaxKShift(num_embeddings=table.shape[0], features=DIM, num_shifts=K, normalize_output=True)
    pred = model.apply({"params": {"embedding": jnp.asarray(table)}}, jnp.asarray(ids))
    return float(jnp.mean((pred - jax_l2(jnp.asarray(embs))) ** 2))


def test_train_reconstruction_matches_jax(data):
    """3 epochs of 4 batches (the last one 16 rows: 8 repeated, as JAX builds it), Adagrad at lr 0.5."""
    _, ids, embs, _, _ = data
    kw = dict(expansion_factor=EXPANSION, k_shift=K, num_epochs=3, batch_size=64, lr=0.5, seed=0)
    want = jgen.train_reconstruction(ids, embs, **kw)["emb_table"]
    got = tgen.train_reconstruction(ids, embs, device="cpu", init=_jax_recon_init(ids), **kw)
    np.testing.assert_allclose(got["emb_table"], want, rtol=0, atol=JOB_TOL)
    assert abs(_recon_loss(got["emb_table"], ids, embs) - _recon_loss(want, ids, embs)) <= JOB_TOL


def test_torch_adagrad_is_not_optax_adagrad(data):
    """The same start and batches under ``torch.optim.Adagrad`` (its eps added
    to sqrt(acc), not inside) end far from JAX's table, while the port's
    Adagrad ends within the tolerance (the test above)."""
    _, ids, embs, _, _ = data
    want = jgen.train_reconstruction(ids, embs, EXPANSION, K, num_epochs=1, batch_size=64, lr=0.5)["emb_table"]
    table = torch.tensor(_jax_recon_init(ids)).requires_grad_()
    opt = torch.optim.Adagrad([table], lr=0.5, initial_accumulator_value=1e-10)
    target = tgen.l2_normalize(torch.from_numpy(embs))
    ids_t = torch.from_numpy(ids)
    for sl in tgen._batches(np.random.RandomState(0), len(ids), 64):
        loss = torch.mean((tgen.kshift_embed(table, ids_t[sl], K) - target[sl]) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
    assert np.abs(table.detach().numpy() - want).max() > 100 * JOB_TOL


def _jax_mask_init(n, seed=1, mask_emb_dim=4, mask_hidden=64):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    rows = int(EXPANSION * n)
    return {
        "mask_table": np.asarray(jax.random.normal(k1, (rows, mask_emb_dim), jnp.float32)),
        "mask_w1": np.asarray(jax.random.normal(k2, (mask_emb_dim, mask_hidden)) / np.sqrt(mask_emb_dim)),
        "mask_b1": np.zeros((mask_hidden,), np.float32),
        "mask_w2": np.asarray(jax.random.normal(k3, (mask_hidden, 1)) / np.sqrt(mask_hidden)),
        "mask_b2": np.zeros((1,), np.float32),
    }


def _mask_score(params, ids):
    """JAX's sigmoid of the mask model's logit."""
    idx = jax_kshift_rows(jnp.asarray(ids), params["mask_table"].shape[0], 4)
    m = jnp.take(jnp.asarray(params["mask_table"]), idx.astype(jnp.int32), axis=0).sum(-2) / 2.0
    h = jax_quick_gelu(m @ params["mask_w1"] + params["mask_b1"])
    return jax.nn.sigmoid((h @ params["mask_w2"] + params["mask_b2"])[..., 0])


def test_train_mask_model_matches_jax(data):
    """2 epochs of 4 batches with as many random negatives, drawn from the
    same RandomState after each permutation: the same id stream, so the
    same parameters within the tolerance; the final BCE on a fixed batch
    within it too."""
    _, ids, _, _, _ = data
    kw = dict(expansion_factor=EXPANSION, num_epochs=2, batch_size=64, lr=0.5, seed=1)
    want = jgen.train_mask_model(ids, **kw)
    got = tgen.train_mask_model(ids, device="cpu", init=_jax_mask_init(len(ids)), **kw)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=MASK_TOL, err_msg=k)
        assert np.mean(np.abs(got[k] - want[k]) <= MASK_MOST_TOL) >= 0.99, k
    neg = np.random.RandomState(9).randint(-(2**63), 2**63 - 1, size=64, dtype=np.int64)
    x = np.concatenate([ids[:64], neg])
    y = np.concatenate([np.ones(64), np.zeros(64)]).astype(np.float32)

    def bce(p):
        s = _mask_score(p, x)
        return float(jnp.mean(optax.sigmoid_binary_cross_entropy(jnp.log(s / (1 - s)), y)))

    assert abs(bce(got) - bce(want)) <= MASK_MOST_TOL * abs(bce(want))


def test_artifact_roundtrip(tmp_path, data):
    _, ids, embs, _, _ = data
    art = tgen.train_reconstruction(ids, embs, 2.0, 4, num_epochs=2, batch_size=64, device="cpu")
    art.update(tgen.train_mask_model(ids, 2.0, num_epochs=1, batch_size=64, device="cpu"))
    tgen.save_artifact(art, str(tmp_path), {"dim": DIM})
    loaded = tgen.load_artifact(str(tmp_path))
    assert set(loaded) == set(art)
    for k in art:
        np.testing.assert_array_equal(loaded[k], art[k])
    assert (tmp_path / "embedding_module_meta.json").exists()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pretrained_module_with_a_jax_artifact_matches_jax(tmp_path, data, dtype):
    """A JAX Orbax artifact, through the JAX package's ``load_artifact`` (its
    dict of numpy arrays), into the port's module."""
    _, ids, embs, _, _ = data
    art = jgen.train_reconstruction(ids, embs, 2.0, 4, num_epochs=2, batch_size=64)
    art.update(jgen.train_mask_model(ids, 2.0, num_epochs=1, batch_size=64))
    jgen.save_artifact(art, str(tmp_path), {"dim": DIM})
    loaded = jax.tree_util.tree_map(np.asarray, jgen.load_artifact(str(tmp_path)))
    rows = int(2.0 * N)
    jdt = None if dtype == "float32" else jnp.bfloat16
    jmod = JaxPretrained(num_embeddings=rows, features=DIM, num_shifts=4, normalize_output=True, compute_dtype=jdt)
    q = ids[:24].reshape(4, 6)
    q[0, -2:] = 0
    want = np.asarray(jmod.apply({"constants": loaded}, jnp.asarray(q)))
    tmod = PretrainedProductEmbedding(rows, DIM, torch.Generator().manual_seed(0), num_shifts=4,
                                      normalize_output=True, compute_dtype=getattr(torch, dtype) if jdt else None)
    load_pretrained_constants(torch.nn.ModuleDict({"product_emb_module": tmod}), loaded)
    got = tmod(torch.from_numpy(q)).numpy()
    tol = F32_TOL if dtype == "float32" else 2**-8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert not any(b.requires_grad for b in tmod.buffers()) and not list(tmod.parameters())


def _pretrained_lthm(tmp_path, ids, embs):
    """JAX and port LTHM wrappers whose product tower names one artifact
    directory: the JAX Orbax artifact and the port's file of the same arrays."""
    art = jgen.train_reconstruction(ids, embs, 2.0, 4, num_epochs=2, batch_size=64)
    art.update(jgen.train_mask_model(ids, 2.0, num_epochs=1, batch_size=64))
    jgen.save_artifact(art, str(tmp_path), {"dim": DIM})
    tgen.save_artifact(jax.tree_util.tree_map(np.asarray, art), str(tmp_path))
    d = small_config(False, "float32")
    d["product_tower"]["inp_emb_dim"] = DIM
    d["product_tower"]["model_init_metadata"] = {"embedding_module_path": str(tmp_path)}
    d["product_tower"]["latent_model_config"] = {"vocab_size_latent": int(2.0 * N), "num_shifts_latent": 4,
                                                 "normalize_embedding": True}
    jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
    batch = small_batch()
    batch["product_ids"][:, :20] = np.resize(ids, (4, 20))  # known ids beside random ones
    vs = jw.init_variables(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
    return jw, vs, tw, batch, art


def test_pretrained_lthm_matches_jax_and_keeps_its_buffers(tmp_path, data):
    _, ids, embs, _, _ = data
    jw, vs, tw, batch, art = _pretrained_lthm(tmp_path, ids, embs)
    emb = tw.module.product_emb_module
    assert isinstance(emb, PretrainedProductEmbedding)
    # the wrapper loaded the artifact at construction
    np.testing.assert_array_equal(emb.emb_table.numpy(), np.asarray(art["emb_table"]))
    np.testing.assert_array_equal(np.asarray(vs["constants"]["product_emb_module"]["mask_w1"]),
                                  np.asarray(art["mask_w1"]))
    tw.load_jax_variables(jax.tree_util.tree_map(np.asarray, vs))
    want = jw.forward(vs, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tw.forward(batch)
    for k in ("next_token_emb", "current_token_emb"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=F32_TOL, err_msg=k)

    # frozen: no parameter of the product-embedding module, the table group
    # empty, and a training step leaves every buffer as it was
    assert tw.config.resolved_table_optimizer() == "frozen"
    assert "EMB_TABLE" not in tw.param_labels().values()
    before = {k: v.clone() for k, v in emb.named_buffers()}
    state = TrainState.create(tw)
    loss, _ = train_step(state, batch, offsets=np.array([0, 1, 2]))
    assert np.isfinite(float(loss))
    for k, v in emb.named_buffers():
        assert torch.equal(v, before[k]), k
