"""The port's ranker (recommendations_tpu_torch.models.ranker, the new layers
of nn/embeddings.py, tools/synth_data.py's ranking logs) against the JAX
package's, on the CPU, with the same weights: QREmbedding,
NAImputationPlusQuantileEmbedding and MLP; each FeatureEncoder kind;
FactorizedDLRM's outputs; binary_auc (ties, pad rows) and ndcg_at_k; the
loss and metrics of one-label and many-label tasks and their gradients;
one AdamW step against optax; tower routing; ranker_train.yaml parsed as
JAX parses it; make_ranking_log column for column; and the port's
main_training on ranker_train.yaml (the in-memory store): JAX's metric
keys, a resume to the same bits, the export reloaded and scoring the same."""

import copy
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.config.trainer_config import ModelTrainConfig as JaxTrainConfig
from recommendations_tpu.config.yaml_loader import load_config as jax_load_config
from recommendations_tpu.config.yaml_loader import parse_cli_overrides as jax_parse
from recommendations_tpu.models.ranker import metrics as jmetrics
from recommendations_tpu.models.ranker import model as jmodel
from recommendations_tpu.models.ranker.config import RankerModelConfig as JaxConfig
from recommendations_tpu.models.ranker.wrapper import RankerModelWrapper as JaxWrapper
from recommendations_tpu.nn import embeddings as jemb
from recommendations_tpu.tools import synth_data as jsynth
from recommendations_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from recommendations_tpu_torch import main_training
from recommendations_tpu_torch.config.base import model_dump, to_json_value
from recommendations_tpu_torch.config.model_config import resolve_model_config
from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
from recommendations_tpu_torch.config.yaml_loader import load_config, parse_cli_overrides
from recommendations_tpu_torch.data.data_store import FakeDataStore
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.models.ranker import metrics as tmetrics
from recommendations_tpu_torch.models.ranker import model as tmodel
from recommendations_tpu_torch.models.ranker.config import RankerModelConfig
from recommendations_tpu_torch.models.ranker.wrapper import RankerModelWrapper
from recommendations_tpu_torch.nn import embeddings as temb
from recommendations_tpu_torch.pipeline.export import load_exported_wrapper
from recommendations_tpu_torch.tools import synth_data as tsynth
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState

torch.set_num_threads(1)

F32_TOL = 2e-5   # float32 forwards (tests/test_fused_attention.py)
GRAD_TOL = 2e-4  # gradients, norm-relative
TOL = 1e-5       # the loss and the metrics, float32
CONFIG_ROOT = main_training.CONFIG_ROOT


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, variables):
    module.load_state_dict(state_dict_from_jax(_np(variables), module))
    return module


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30)


def _check_grads(module, jgrads, tol=GRAD_TOL):
    want = state_dict_from_jax({"params": _np(jgrads)}, module)
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        assert _rel(p.grad.numpy(), want[name].numpy()) <= tol, name


# -- the layers -------------------------------------------------------------------


@pytest.mark.parametrize("n,normalize", [(10007, False), (4096, True)])
def test_qr_embedding_matches_jax(n, normalize):
    """Forward at 2e-5 and the two tables' gradients (duplicate ids summed)
    at 2e-4."""
    rs = np.random.RandomState(n)
    ids = rs.randint(-(2**62), 2**62, size=(6, 5)).astype(np.int64)
    ids[1] = ids[0]  # duplicate rows
    g = rs.randn(6, 5, 8).astype(np.float32)
    jm = jemb.QREmbedding(num_embeddings=n, features=8, normalize_output=normalize)
    vs = jm.init(jax.random.PRNGKey(1), jnp.asarray(ids))
    want = np.asarray(jm.apply(vs, jnp.asarray(ids)))
    jg = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(ids)) * g))(vs["params"])
    tm = _load(temb.QREmbedding(n, 8, _gen(), normalize_output=normalize), vs)
    assert tm.emb_q.shape == (int(np.sqrt(n)), 8)
    got = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    (got * torch.from_numpy(g)).sum().backward()
    _check_grads(tm, jg)
    with pytest.raises(TypeError):
        tm(torch.zeros(3))


def test_na_imputation_quantile_embedding_matches_jax():
    """Values below the first quantile, above the last, on a quantile, equal
    to na_value and below it: the NA test is one-sided in both packages
    (every x < na_value + eps is NA, ROADMAP section 3)."""
    quantiles = (-1.0, 0.0, 0.5, 2.0, 10.0)
    x = np.array([[-8.0, -1.0, -0.5, 0.0, 0.25], [0.5, 3.0, 50.0, -7.0, -5.0]], np.float32)
    jm = jemb.NAImputationPlusQuantileEmbedding(na_value=-7.0, quantiles=quantiles)
    vs = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    vs["params"]["na_param"] = np.array([0.75], np.float32)
    want = np.asarray(jm.apply(vs, jnp.asarray(x)))
    tm = _load(temb.NAImputationPlusQuantileEmbedding(-7.0, quantiles), vs)
    got = tm(torch.from_numpy(x))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # -8 lies below na_value and is NA (the one-sided test); -5 is not
    assert want.shape == (2, 5, 1) and want[0, 0, 0] == want[1, 3, 0] == 0.75 != want[1, 4, 0]
    fresh = temb.NAImputationPlusQuantileEmbedding(-7.0, quantiles)
    np.testing.assert_array_equal(fresh.embedding.detach().numpy(),
                                  np.asarray(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]["embedding"]))


@pytest.mark.parametrize("gate_sizes,use_bias", [((8, 6), True), ((), False)])
def test_mlp_matches_jax(gate_sizes, use_bias):
    x = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    jm = jemb.MLP(out_dim=4, gate_sizes=gate_sizes, use_bias=use_bias)
    vs = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    want = np.asarray(jm.apply(vs, jnp.asarray(x)))
    tm = _load(temb.MLP(5, 4, _gen(), gate_sizes=gate_sizes, use_bias=use_bias), vs)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), want, rtol=F32_TOL, atol=F32_TOL)


# -- the model ----------------------------------------------------------------------

D = 16


def kinds_config(**over):
    """A ranker config with one feature of every kind the encoder takes."""
    d = dict(
        emb_dim=D, tower_hidden=(32,), tower_dim=16, top_hidden=(32,), num_embeddings_default=10007,
        embedding_tables={},
        tasks=[{"name": "click", "kind": "numerical", "num_labels": 1, "weight": 1.0},
               {"name": "grade", "kind": "numerical", "num_labels": 3, "weight": 0.5}],
        features={
            "defaults": {"categorical_features": {"default_dtype": "string", "transform_value_to_lowercase": False,
                                                  "value_to_number_mapper": {"kind": "xxhash"}}},
            "embedding_tables": {"flat_t": {"num_embeddings": 5000, "emb_dim": D, "use_qr": False}},
            "categorical_features": [
                {"name": "product_id", "kind": "categorical", "tower_name": "product"},
                {"name": "customer_id", "kind": "categorical", "tower_name": "user", "emb_table_name": "flat_t"},
                {"name": "search_query", "kind": "categorical", "tower_name": "query"},
            ],
            "numerical_features": [
                {"name": "price", "kind": "numerical", "tower_name": "product"},
                {"name": "position", "kind": "numerical", "tower_name": "query"},
                {"name": "click", "kind": "numerical", "tower_name": "other"},
            ],
            "bool_features": [{"name": "is_returning_user", "kind": "bool", "tower_name": "user"}],
            "timestamp_features": [{"name": "event_ts", "kind": "timestamp", "tower_name": "query"}],
            "one_hot_string_features": [{"name": "colors", "kind": "one_hot_string", "tower_name": "product"}],
            "lat_lng_features": [{"name": "geo", "kind": "latlong", "tower_name": "user"}],
            "tensor_features": [{"name": "user_vec", "kind": "tensor", "tower_name": "user", "emb_dim": 5}],
        },
    )
    del d["embedding_tables"]
    d.update(over)
    return d


def kinds_batch(n=24, seed=0, pad=0):
    """make_ranking_log's columns through the port's feature pipeline, plus
    a one-hot string bag (-1 padded, ids past the bag clipped), a lat-long,
    a tensor feature, a 3-class label and, with ``pad``, the last rows
    marked padding."""
    import yaml

    with open(CONFIG_ROOT / "model" / "ranker.yaml") as f:
        yaml_features = RankerModelConfig.from_dict(yaml.safe_load(f)).features
    log = tsynth.make_ranking_log(num_rows=n, seed=seed)
    table = yaml_features.default_data_mapper(log)
    rs = np.random.RandomState(seed + 100)
    colors = rs.randint(-1, 600, size=(n, 4))
    colors[:, -1] = -1
    batch = {k: np.asarray(v) for k, v in table.items() if np.asarray(v).dtype != object}
    batch.update(colors=colors.astype(np.int64), geo=rs.randn(n, 2).astype(np.float32) * 50,
                 user_vec=rs.randn(n, 5).astype(np.float32), grade=(log["position"] % 3).astype(np.float32))
    if pad:
        batch["_pad_mask"] = np.arange(n) >= n - pad
    return batch


_PAIRS = {}


def _pair(**over):
    """(JAX wrapper, variables, port wrapper with the same weights)."""
    key = repr(sorted(over.items()))
    if key not in _PAIRS:
        d = kinds_config(**over)
        jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
        vs = _np(jw.init_variables(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in kinds_batch().items()}))
        _PAIRS[key] = (jw, vs)
    jw, vs = _PAIRS[key]
    tw = RankerModelWrapper(RankerModelConfig.from_dict(kinds_config(**over)), device="cpu")
    tw.load_jax_variables(vs)
    return jw, vs, tw


@pytest.mark.parametrize("feature", ["product_id", "customer_id", "event_ts", "colors", "price",
                                     "is_returning_user", "geo", "user_vec"])
def test_feature_encoder_matches_jax(feature):
    """Each kind (categorical on the QR default and on a flat table named by
    embedding_tables, timestamp, one-hot string, numerical, bool, lat-long,
    tensor): forward at 2e-5 and its parameters' gradients at 2e-4."""
    batch = kinds_batch(seed=1)
    x = batch[feature]
    jc = JaxConfig(**kinds_config())
    jm = jmodel.FeatureEncoder(jc, feature_name=feature)
    vs = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))
    want = np.asarray(jm.apply(vs, jnp.asarray(x)))
    g = np.random.RandomState(5).randn(*want.shape).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * g))(vs["params"])
    tm = _load(tmodel.FeatureEncoder(RankerModelConfig.from_dict(kinds_config()), feature, _gen()), vs)
    got = tm(torch.from_numpy(x))
    assert want.shape == (x.shape[0], D)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    (got * torch.from_numpy(g)).sum().backward()
    _check_grads(tm, jg)


@pytest.mark.parametrize("interaction_self", [False, True])
def test_factorized_dlrm_matches_jax(interaction_self):
    """Every output (each task's logits and _representation) at 2e-5, and
    the scorer's sigmoid and softmax."""
    jw, vs, tw = _pair(interaction_self=interaction_self)
    batch = kinds_batch(seed=2)
    want = jw.forward(vs, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tw.forward(batch)
    assert set(got) == set(want) == {"click", "grade", "_representation"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=F32_TOL, atol=F32_TOL, err_msg=k)
    assert tw.module.iu.shape[0] == (10 * 11 // 2 if interaction_self else 10 * 9 // 2)  # 10 routed features
    js = jw.inference_models()["ranker_scorer"](vs, {k: jnp.asarray(v) for k, v in batch.items()})
    ts = tw.inference_models()["ranker_scorer"](batch)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=F32_TOL, atol=F32_TOL, err_msg=k)


@pytest.mark.parametrize("pad", [0, 5])
def test_loss_metrics_and_grads_match_jax(pad):
    """A one-label task (BCE, AUC, positive rate) and a 3-label task (CE,
    accuracy), weighted and with pad rows: the loss and every metric at
    1e-5 under the same keys, every gradient at 2e-4."""
    jw, vs, tw = _pair()
    batch = kinds_batch(n=40, seed=3, pad=pad)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for training in (True, False):
        tw.module.zero_grad(set_to_none=True)

        def loss_fn(p):
            return jw.loss_and_metrics(p, {}, None, jbatch, jax.random.PRNGKey(0), training)

        (jl, (jm, _)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(vs["params"])
        tl, tm, aux = tw.loss_and_metrics(batch, None, training, offsets=None, dropout_seed=7)
        assert aux is None and set(tm) == set(jm)
        assert abs(tl.item() - float(jl)) <= TOL
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= TOL, k
        tl.backward()
        _check_grads(tw.module, jg)


def test_adamw_step_matches_optax():
    """One step of the port's train_step (the ranker's USE_OPTIM AdamW group
    at the config's lr and weight decay) against optax's, from the same
    weights: every updated parameter within 2e-4 norm-relative."""
    import optax

    over = dict(lr=3e-3, weight_decay=1e-2)
    jw, vs, tw = _pair(**over)
    batch = kinds_batch(n=32, seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = vs["params"]
    opt = jax_build_optimizer(jw, JaxTrainConfig(), params)
    grads = jax.jit(jax.grad(lambda p: jw.loss_and_metrics(p, {}, None, jbatch, jax.random.PRNGKey(0), True)[0]))(params)
    updates, _ = jax.jit(opt.update)(grads, opt.init(params), params)
    want = state_dict_from_jax({"params": _np(optax.apply_updates(params, updates))}, tw.module)
    state = TrainState.create(tw, ModelTrainConfig())
    assert state.aux is None and state.table_state is None
    loss, metrics = train_step(state, batch)
    assert set(metrics) >= {"grad_norm", "params_nan", "train_loss", "train_auc_click", "train_acc_grade"}
    assert state.step == 1 and float(metrics["params_nan"]) == 0.0
    for name, p in tw.module.named_parameters():
        assert _rel(p.detach().numpy(), want[name].numpy()) <= GRAD_TOL, name


def test_tower_routing_as_jax():
    """By tower_name over every feature list (tensor features included);
    explicit lists override; no routed feature raises."""
    d = kinds_config()
    jc, tc = JaxConfig(**copy.deepcopy(d)), RankerModelConfig.from_dict(copy.deepcopy(d))
    for attr in ("query_features_list", "product_features_list", "user_features_list"):
        assert getattr(tc, attr) == getattr(jc, attr)
    assert tc.user_features_list == ["customer_id", "is_returning_user", "geo", "user_vec"]
    over = RankerModelConfig.from_dict(kinds_config(item_features=["price"], user_features=[]))
    assert over.product_features_list == ["price"] and over.user_features_list == []
    with pytest.raises(ValueError, match="no routed features"):
        tmodel.FactorizedDLRM(RankerModelConfig.from_dict(kinds_config(query_features=[], item_features=[],
                                                                       user_features=[])), _gen())


def test_metrics_match_jax():
    """binary_auc with tied scores and pad rows (which take rank slots before
    the mask, in both packages), single-class and all-pad batches (0.5);
    ndcg_at_k with tied scores and k past the row length."""
    rs = np.random.RandomState(6)
    scores = np.round(rs.randn(200), 1).astype(np.float32)  # many ties
    labels = (rs.rand(200) < 0.3).astype(np.float32)
    valid = rs.rand(200) < 0.8
    for v in (None, valid, np.zeros(200, bool)):
        want = float(jmetrics.binary_auc(jnp.asarray(scores), jnp.asarray(labels),
                                         None if v is None else jnp.asarray(v)))
        got = float(tmetrics.binary_auc(torch.from_numpy(scores), torch.from_numpy(labels),
                                        None if v is None else torch.from_numpy(v)))
        assert abs(got - want) <= 1e-6
    assert float(tmetrics.binary_auc(torch.from_numpy(scores), torch.ones(200))) == 0.5
    s2 = np.round(rs.randn(6, 9), 1).astype(np.float32)
    rel = rs.randint(0, 3, size=(6, 9)).astype(np.float32)
    for k in (1, 4, 20):
        want = float(jmetrics.ndcg_at_k(jnp.asarray(s2), jnp.asarray(rel), k))
        got = float(tmetrics.ndcg_at_k(torch.from_numpy(s2), torch.from_numpy(rel), k))
        assert abs(got - want) <= 1e-6, k


# -- config, data ----------------------------------------------------------------


def _plain(d):
    return json.loads(json.dumps(to_json_value(d)))


def test_ranker_yaml_parsed_as_jax():
    """ranker_train.yaml composed by both loaders: every section dumps to
    the same dict, the model resolves to the port's RankerModelConfig, and
    the model dump (the export's config.json) builds it again."""
    args = ["model_version=v1", "run_id=r1"]
    path = CONFIG_ROOT / "ranker_train.yaml"
    jcfg = jax_load_config(path, overrides=jax_parse(args), search_paths=[str(CONFIG_ROOT)])
    tcfg = load_config(path, overrides=parse_cli_overrides(args), search_paths=[str(CONFIG_ROOT)])
    assert isinstance(tcfg.model, RankerModelConfig)
    assert _plain(model_dump(tcfg, serialize_as_any=True)) == _plain(jcfg.model_dump(serialize_as_any=True))
    assert _plain(model_dump(tcfg.model)) == _plain(jcfg.model.model_dump())
    assert tcfg.model.features.get_input_columns() == jcfg.model.features.get_input_columns()
    again = resolve_model_config("ranker", "ranker_model").from_dict(_plain(model_dump(tcfg.model)))
    assert _plain(model_dump(again)) == _plain(model_dump(tcfg.model))
    assert tcfg.model.tower_hidden == (128, 64) and tcfg.model.num_embeddings_default == 2**20


@pytest.mark.parametrize("seed", [0, 7])
def test_make_ranking_log_matches_jax(seed):
    want = jsynth.make_ranking_log(num_rows=500, seed=seed)
    got = tsynth.make_ranking_log(num_rows=500, seed=seed)
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype, c
        np.testing.assert_array_equal(got[c], w, err_msg=c)


# -- the trainer ------------------------------------------------------------------

STEPS = 6


def _run(tmp, tag, ckpt_dir):
    argv = ["--config-name", "ranker_train", "--device", "cpu", "dataset.filesystem_config.kind=fake",
            f"train.train_steps={STEPS}", "train.validation_steps=2", "train.val_metrics_every_n_steps=3",
            "train.train_metrics_every_n_steps=3", "train.checkpoint_every_k_steps=3", f"checkpoint_dir={ckpt_dir}",
            f"export.filesystem_config.local_dir_prefix={tmp}/export_{tag}",
            f"trackers.trackers=[{{kind: jsonl, path: {tmp}/{tag}.jsonl}}]", f"model_version={tag}", "run_id=r1"]
    return main_training.main(argv, return_pipeline=True)


def test_main_training_on_ranker_train_yaml(tmp_path):
    """The port's entry point on ranker_train.yaml (6 steps of 256 from the
    in-memory store, validation and a checkpoint every 3): the jsonl lines
    under JAX's keys with finite losses; a second run resumed from the
    step-3 checkpoint ends on the same bits; the export reloads into a fresh
    wrapper (dispatched on its config's kind) that scores the same."""
    tmp = str(tmp_path)
    FakeDataStore.reset()
    try:
        tsynth.write_ranking_dataset(None, ["20240101", "20240102"], files_per_date=2, rows_per_file=1024,
                                     fake_store=True)
        pipe_a, _ = _run(tmp, "a", f"{tmp}/ckpt_a")
        wrapper, state_a = pipe_a._trained
        assert isinstance(wrapper, RankerModelWrapper) and state_a.step == STEPS
        with open(f"{tmp}/a.jsonl") as f:
            lines = [r["metrics"] for r in map(json.loads, f) if r["event"] == "metrics"]
        # JAX's own keys: its loss_and_metrics on a batch, and its strategy's
        jcfg = jax_load_config(CONFIG_ROOT / "ranker_train.yaml", search_paths=[str(CONFIG_ROOT)])
        jw = JaxWrapper(jcfg.model)
        jb = {k: jnp.asarray(v) for k, v in kinds_batch().items() if k in jcfg.model.features.get_input_columns()}
        jvs = jw.init_variables(jax.random.PRNGKey(0), jb)
        keys = {p: set(jw.loss_and_metrics(jvs["params"], {}, None, jb, jax.random.PRNGKey(0), p == "train")[1][0])
                for p in ("train", "val")}
        train = [m for m in lines if "train_loss" in m]
        val = [m for m in lines if "val_loss" in m]
        assert [m["steps"] for m in train] == [3, 6] and len(val) == 2
        for m in train:
            assert set(m) == keys["train"] | {"grad_norm", "params_nan", "training speed - samples per second",
                                              "epoch", "steps"}
        for m in val:
            assert set(m) - {"RAM Available - GB"} == keys["val"] | {"val_batches_skipped_nan",
                                                                     "eval speed - samples per second"}
        assert np.isfinite([m[k] for m in lines for k in m if "loss" in k]).all()

        os.makedirs(f"{tmp}/ckpt_b")
        shutil.copy(f"{tmp}/ckpt_a/step_00000003.pt", f"{tmp}/ckpt_b/step_00000003.pt")
        pipe_b, _ = _run(tmp, "b", f"{tmp}/ckpt_b")
        state_b = pipe_b._trained[1]
        sa, sb = state_a.state_dict(), state_b.state_dict()
        for name, t in sa["module"].items():
            assert torch.equal(t, sb["module"][name]), name
        for oa, ob in zip(sa["optimizers"], sb["optimizers"]):
            for pid, st in oa["state"].items():
                for k, t in st.items():
                    assert torch.equal(t, ob["state"][pid][k]), (pid, k)

        # the YAML's batch inference ran after training (tests/test_torch_export_inference.py
        # holds it to JAX's run_inference): a score a validation impression
        import pyarrow.parquet as pq

        scores = pq.read_table(os.path.join(pipe_a.export_dir(), "inference", "inference_results.parquet"))
        assert scores.num_rows == 2 * 1024 and {"ranker_scorer.click", "ranker_scorer.conversion"} <= set(
            scores.column_names)

        fresh = load_exported_wrapper(pipe_a.export_dir(), device="cpu")
        assert isinstance(fresh, RankerModelWrapper)
        batch = {k: v for k, v in kinds_batch(seed=9).items()}
        want = wrapper.inference_models()["ranker_scorer"](batch)
        got = fresh.inference_models()["ranker_scorer"](batch)
        assert set(got) == {"click", "conversion"}
        for k in want:
            assert torch.equal(got[k], want[k]), k
    finally:
        FakeDataStore.reset()


def test_main_training_on_ranker_parquet_in_a_subprocess(tmp_path):
    """The README's ranker commands: the port's synth writes parquet, the
    entry point trains 4 steps from it (one reader thread: the loader's
    first parquet read in a thread that then exits used to crash the next
    reading thread inside pyarrow) and exports, in a process of its own."""
    pytest.importorskip("pyarrow")
    root, out = tmp_path / "data", tmp_path / "out"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    subprocess.run([sys.executable, "-m", "recommendations_tpu_torch.tools.synth_data", "--ranking", "--root",
                    str(root), "--dates", "20240101", "20240102"], check=True, env=env, cwd=repo, timeout=300)
    run = subprocess.run(
        [sys.executable, "-m", "recommendations_tpu_torch.main_training", "--config-name", "ranker_train", "--device",
         "cpu", "train.train_steps=4", "train.validation_steps=2", "inference.skip_inference=true",
         f"dataset.filesystem_config.local_dir_prefix={root}", f"export.filesystem_config.local_dir_prefix={out}",
         f"trackers.trackers=[{{kind: jsonl, path: {out}/m.jsonl}}]", "model_version=p"],
        env=env, cwd=repo, timeout=300, capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-2000:]
    assert os.path.exists(out / "ranker" / "dev" / "p" / "config.json")
