"""The port's LTHM serving forward (recommendations_tpu_torch.models.lthm)
against the JAX package's, on the CPU, with the same weights: config,
weight conversion, the whole forward on the flash and non-flash JAX paths,
the serving entry points, and the device rule (no silent CPU)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.models.lthm.config import LTHMModelConfig as JaxConfig
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxWrapper
from recommendations_tpu.nn import functional as jfn
from recommendations_tpu.nn import lsh as jlsh
import recommendations_tpu_torch
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.nn.functional import l2_normalize
from recommendations_tpu_torch.ops import fused_attention as tfa

torch.set_num_threads(1)


def small_config(use_flash: bool, compute_dtype: str) -> dict:
    """2 layers, d=64, MQA with 4 heads, context 48."""
    return dict(
        features={"defaults": {}},
        compute_dtype=compute_dtype,
        transformer_config=dict(
            rotator_config={"ff_mult": 4},
            is_causal=True,
            num_layers=2,
            use_flash_attention=use_flash,
            attn_config=dict(
                n_head=4, n_embd=64, attn_type="multi_query",
                dropout=0.0, attn_dropout=0.0, bias=False,
            ),
        ),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=64, product_emb_dim=32, norm_bins=8,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 16}, {"num_bins": 8, "num_proj": 16}],
            latent_model_config={
                "vocab_size_latent": 5000, "num_shifts_latent": 4, "normalize_embedding": True,
            },
        ),
        log_q_config={"num_buckets": 1024, "hash_offsets": [0, 7]},
        lookahead=[0, 2, 4],
        context_width=48,
        table_optimizer="frozen",
    )


def small_batch(b=4, s=56, seed=0):
    """Right-padded histories (pad id 0), float32 labels and timestamps."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(-(2**62), 2**62, size=(b, s)).astype(np.int64)
    ids[:, -5:] = 0
    ids[1, 30:] = 0
    return {
        "product_ids": ids,
        "labels": rs.randint(0, 4, size=(b, s)).astype(np.float32),
        "timestamps": rs.randint(1_600_000_000, 1_700_000_000, size=(b, s)).astype(np.float32),
    }


_CACHE = {}


def _pair(use_flash: bool, compute_dtype: str):
    """(JAX wrapper, variables, port wrapper with the same weights), built
    once per configuration."""
    key = (use_flash, compute_dtype)
    if key not in _CACHE:
        d = small_config(use_flash, compute_dtype)
        jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
        batch = {k: jnp.asarray(v) for k, v in small_batch().items()}
        vs = jw.init_variables(jax.random.PRNGKey(0), batch)
        tw = LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
        tw.load_jax_variables(jax.tree_util.tree_map(np.asarray, vs))
        _CACHE[key] = (jw, vs, tw)
    return _CACHE[key]


def _np(x):
    return np.asarray(x).astype(np.float32) if np.asarray(x).dtype != bool else np.asarray(x)


def test_config_from_one_dict_matches_jax():
    d = small_config(True, "bfloat16")
    d["product_tower"]["item_emb_dim"] = 40  # alias: product_emb_dim wins when both given
    d["product_tower"]["model_init_metadata"] = "???"
    d["transformer_config"]["attn_config"]["pos_bias"] = {"context_window": 49}
    jc = JaxConfig(**copy.deepcopy(d)).model_dump()
    tc = dataclasses.asdict(LTHMModelConfig.from_dict(copy.deepcopy(d)))
    for name, val in tc.items():
        if name in ("features", "kind"):
            continue
        assert val == jc[name], name
    assert tc["product_tower"]["product_emb_dim"] == 32
    assert tc["product_tower"]["model_init_metadata"] is None
    alias = small_config(True, "bfloat16")
    del alias["product_tower"]["product_emb_dim"]
    alias["product_tower"]["item_emb_dim"] = 24
    assert LTHMModelConfig.from_dict(alias).product_tower.product_emb_dim == 24
    with pytest.raises(TypeError):
        LTHMModelConfig.from_dict({**d, "no_such_field": 1})
    with pytest.raises(ValueError):
        LTHMModelConfig.from_dict({**d, "table_optimizer": "sgd"})


@pytest.mark.parametrize("name", ["lthm.yaml", "lthm_tiny.yaml"])
def test_config_from_repo_yaml_matches_jax(name):
    import os

    import yaml

    path = os.path.join(os.path.dirname(__file__), "..", "configs", "model", name)
    with open(path) as f:
        d = yaml.safe_load(f)
    jc = JaxConfig(**copy.deepcopy(d)).model_dump()
    tc = dataclasses.asdict(LTHMModelConfig.from_dict(copy.deepcopy(d)))
    for field_name, val in tc.items():
        if field_name not in ("features", "kind"):
            assert val == jc[field_name], field_name


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_f32_matches_jax(use_flash):
    jw, vs, tw = _pair(use_flash, "float32")
    batch = small_batch()
    want = jw.forward(vs, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tw.forward(batch)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        if k in ("current_token_mask", "current_token_ids"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            np.testing.assert_allclose(got[k].numpy(), _np(want[k]), rtol=0, atol=1e-4, err_msg=k)


def _lsh_flips(jw, vs, tw, batch) -> int:
    """Tokens where any cosine-LSH bucket differs between the packages, each
    computed from its own product embedding."""
    cfg = jw.config
    ids = jnp.asarray(batch["product_ids"])
    from recommendations_tpu.nn.embeddings import KShiftEmbedding

    lm = cfg.product_tower.latent_model_config
    jemb = KShiftEmbedding(
        lm.vocab_size_latent, cfg.product_tower.inp_emb_dim, num_shifts=lm.num_shifts_latent,
        normalize_output=lm.normalize_embedding, compute_dtype=jnp.dtype(cfg.compute_dtype),
    ).apply({"params": vs["params"]["product_emb_module"]}, ids)
    jxn = jfn.l2_normalize(jemb.astype(jnp.float32))
    with torch.no_grad():
        txn = l2_normalize(tw.module.product_emb_module(torch.from_numpy(batch["product_ids"])).float())
    flipped = np.zeros(ids.shape, bool)
    for i, spec in enumerate(cfg.product_tower.cosine_lsh_config):
        proj = vs["constants"]["product_tower"][f"direction_emb_{i}"]["projection_mat"]
        res = 2.0 / float(spec.num_bins)
        grid = (jnp.linspace(-1.0, 1.0, spec.num_bins + 1)[:-1] + 0.5 * res).astype(jnp.float32)
        jb = np.asarray(jlsh._bucketize(jfn.l2_normalize(jxn) @ proj, grid))
        tb = getattr(tw.module.product_tower, f"direction_emb_{i}").buckets(txn).numpy()
        flipped |= (jb != tb).any(-1)
    return int(flipped.sum())


@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_bf16_matches_jax(use_flash):
    """bf16 compute. bf16 keeps 8 significant bits, and the two packages
    round at different points inside fused ops (bias add, GELU, the
    LayerNorm output), so about 40% of outputs differ by an ulp that the
    later layers carry along. Held: every element within 2**-6 of the
    largest output (two ulps there), the mean error within 2**-8 of the
    mean magnitude, and the unit user vectors within 2**-7. Tokens whose LSH
    bucket flipped are counted and held to at most 1% of tokens; they stay
    in every comparison."""
    jw, vs, tw = _pair(use_flash, "bfloat16")
    batch = small_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    flips = _lsh_flips(jw, vs, tw, batch)
    assert flips <= 0.01 * batch["product_ids"].size, f"{flips} tokens flipped an LSH bucket"
    want = jw.forward(vs, jbatch)
    got = tw.forward(batch)
    np.testing.assert_array_equal(got["current_token_mask"].numpy(), np.asarray(want["current_token_mask"]))
    for k in ("current_token_emb", "next_token_emb"):
        w, g = _np(want[k]), got[k].numpy()
        assert np.abs(g - w).max() <= 2**-6 * np.abs(w).max(), k
        assert np.abs(g - w).mean() <= 2**-8 * np.abs(w).mean(), k
    ju = jw.inference_models()["user_encoder"](vs, jbatch)["user_emb"]
    tu = tw.inference_models()["user_encoder"](batch)["user_emb"]
    np.testing.assert_allclose(tu.numpy(), _np(ju), rtol=0, atol=2**-7)


def test_serving_entry_points_match_jax():
    jw, vs, tw = _pair(True, "float32")
    batch = small_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm, tm = jw.inference_models(), tw.inference_models()
    assert set(jm) == set(tm) == {"user_encoder", "sequence_encoder"}
    ju, tu = jm["user_encoder"](vs, jbatch), tm["user_encoder"](batch)
    assert set(tu) == set(ju) == {"user_emb"}
    assert tuple(tu["user_emb"].shape) == (4, 32)
    np.testing.assert_allclose(tu["user_emb"].numpy(), _np(ju["user_emb"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tu["user_emb"].norm(dim=-1).numpy(), 1.0, atol=1e-5)
    js, ts = jm["sequence_encoder"](vs, jbatch), tm["sequence_encoder"](batch)
    assert {k: tuple(v.shape) for k, v in ts.items()} == {k: tuple(v.shape) for k, v in js.items()}


def test_convert_fails_loudly():
    jw, vs, tw = _pair(False, "float32")
    variables = jax.tree_util.tree_map(np.asarray, vs)
    state_dict_from_jax(variables, tw.module)  # complete: no error
    missing = copy.deepcopy(variables)
    del missing["params"]["query_tower"]["pad"]
    with pytest.raises(KeyError, match="pad"):
        state_dict_from_jax(missing, tw.module)
    extra = copy.deepcopy(variables)
    extra["params"]["query_tower"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="stray"):
        state_dict_from_jax(extra, tw.module)
    no_constants = {"params": variables["params"]}
    with pytest.raises(KeyError, match="projection_mat"):
        state_dict_from_jax(no_constants, tw.module)
    bad = copy.deepcopy(variables)
    bad["params"]["query_tower"]["emb_heads"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="emb_heads"):
        state_dict_from_jax(bad, tw.module)


def test_no_silent_cpu(monkeypatch):
    d = small_config(True, "float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)))
    with pytest.raises(RuntimeError):
        recommendations_tpu_torch.resolve_device()
    with pytest.raises(ValueError):
        recommendations_tpu_torch.resolve_device("meta")
    # on the CPU the flash layers take the plain version and launch nothing
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu", seed=3)
    before = tfa.FLASH_FWD.launches
    out = tw.inference_models()["user_encoder"](small_batch())
    assert tfa.FLASH_FWD.launches == before == 0
    assert torch.isfinite(out["user_emb"]).all()


def test_format_inputs_rejects_float_ids():
    _, _, tw = _pair(False, "float32")
    batch = small_batch()
    batch["product_ids"] = batch["product_ids"].astype(np.float64)
    with pytest.raises(TypeError, match="product_ids"):
        tw.format_inputs(batch)


def test_sharded_sparse_fused_adam_falls_back_to_rowwise_adam_and_warns(caplog):
    """With shard_embedding_rows the fused record is not used: the wrapper
    gives the JAX wrapper's warning and the table trains in its own group on
    the dense RowwiseAdam (the JAX wrapper's fallback)."""
    from recommendations_tpu_torch.train.optimizers import RowwiseAdam
    from recommendations_tpu_torch.train.step import train_step
    from recommendations_tpu_torch.train.train_state import TrainState

    d = small_config(False, "float32")
    d.update(table_optimizer="sparse_fused_adam", shard_embedding_rows=True)
    d["product_tower"]["detach_item_tower"] = False
    with caplog.at_level("WARNING"):
        tw = LTHMModelWrapper(LTHMModelConfig.from_dict(d), device="cpu")
    assert "falls back to dense rowwise_adam" in caplog.text
    assert not tw.uses_sparse_taps() and not tw.uses_lazy_table()
    table = tw.module.product_emb_module.embedding
    before = table.detach().clone()
    state = TrainState.create(tw)
    assert isinstance(state.optimizer.table, RowwiseAdam)
    assert any(p is table for g in state.optimizer.table.param_groups for p in g["params"])
    loss, metrics = train_step(state, small_batch(), offsets=np.asarray([0, 1, 3]))
    assert np.isfinite(float(loss)) and float(metrics["params_nan"]) == 0.0
    moved = (table.detach() != before).any(dim=1)
    assert 0 < int(moved.sum()) < table.shape[0]
