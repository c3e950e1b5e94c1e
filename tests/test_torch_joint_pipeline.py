"""The port's joint retrieval -> ranking pipeline against the JAX package's,
on the CPU:

- ``configs/joint_train.yaml`` composes into the same stage configs (each
  stage's dump equal to JAX's pydantic dump) and the same encode, synth
  and ablation settings;
- the synth stage writes JAX's files (the same rows, value for value);
- the encode stage, from the same weights (``load_jax_variables``) and the
  same parquet: the user table has JAX's keys (each file's last partial
  batch left out) and vectors within 2e-5 (f32), the item table too;
- ``attach_user_embeddings`` joins as JAX's, zeros for a cold user;
- ``run_joint`` trains the ranker on the user vectors to a finite loss;
- a tiny ``main_training --config-name joint_train`` run ends with both
  arms' metrics and ``auc_uplift_click``, the enriched parquet holding both
  embedding columns.

JAX runs op by op in the encode comparison (``jax.disable_jit()``): its
item table comes from the catalog encoder, whose compiled form drops the
bf16 rounding of the LSH embedding's one-hot product, which the port keeps
(``tests/test_torch_knn_eval.py`` shows that to be the whole difference).
"""

import copy
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recommendations_tpu.config.yaml_loader import load_config as jax_load_config
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxWrapper
from recommendations_tpu.pipeline import joint_pipeline as jjp
from recommendations_tpu.tools import joint_pipeline as jtools
from recommendations_tpu.train.train_state import TrainState as JaxTrainState
from recommendations_tpu_torch import main_training
from recommendations_tpu_torch.config.base import model_dump
from recommendations_tpu_torch.config.yaml_loader import load_config
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.models.ranker.config import RankerModelConfig
from recommendations_tpu_torch.pipeline import joint_pipeline as tjp
from recommendations_tpu_torch.tools import joint_pipeline as ttools
from recommendations_tpu_torch.tools import synth_data as tsynth
from tests.test_torch_config_loader import CONFIG_ROOT, _plain

F32_TOL = 2e-5


def tiny_overrides(root: str) -> dict:
    """tests/test_joint_train_config.py's tiny run."""
    return {
        "enriched_dir": f"{root}/enriched",
        "synth": {"root": f"{root}/data", "users": 100, "products": 200, "clusters": 4, "files_per_date": 2,
                  "train_rows": 2048, "val_rows": 512},
        "retrieval": {"overrides": {
            "dataset": {"filesystem_config": {"local_dir_prefix": f"{root}/data"},
                        "path_glob_train": f"{root}/data/clicks/*/*.parquet",
                        "path_glob_test": f"{root}/data/clicks/*/part-00000.parquet"},
            "train": {"train_steps": 12, "epochs": 4, "batch_size": 16, "validation_steps": 0,
                      "train_metrics_every_n_steps": 6, "val_metrics_every_n_steps": 0},
            "model": {"compute_dtype": "float32"},
        }},
        "ranking": {"overrides": {
            "dataset": {"filesystem_config": {"local_dir_prefix": f"{root}/data"},
                        "path_glob_train": f"{root}/data/impressions/*/*.parquet",
                        "path_glob_test": f"{root}/data/impressions_val/*/*.parquet"},
            "train": {"train_steps": 20, "epochs": 4, "batch_size": 64, "validation_steps": 4,
                      "train_metrics_every_n_steps": 10, "val_metrics_every_n_steps": 20},
        }},
        "encode": {"batch_size": 16},
    }


def _load(over=None):
    kw = dict(overrides=copy.deepcopy(over), search_paths=[str(CONFIG_ROOT)])
    return (jax_load_config(CONFIG_ROOT / "joint_train.yaml", **kw),
            load_config(CONFIG_ROOT / "joint_train.yaml", **kw))


def test_joint_config_as_jax():
    # each stage's model_version and run_id come from the clock unless set
    pinned = {"model_version": "v1", "run_id": "r1"}
    jc, tc = _load({"retrieval": {"overrides": pinned}, "ranking": {"overrides": pinned}})
    assert isinstance(tc, tjp.JointPipelineConfig)
    for stage in ("retrieval", "ranking"):
        t, j = getattr(tc, stage), getattr(jc, stage)
        # the model as the config-loader tests compare it (JAX's pipeline dump
        # serializes the model as its declared base class)
        assert _plain(model_dump(t.model)) == _plain(j.model.model_dump()), stage
        td, jd = _plain(model_dump(t)), _plain(j.model_dump())
        td.pop("model"), jd.pop("model")
        assert td == jd, stage
    assert _plain(model_dump(tc.encode)) == _plain(jc.encode.model_dump())
    assert _plain(model_dump(tc.synth)) == _plain(jc.synth.model_dump())
    assert (tc.enriched_dir, tc.ablation, tc.joint) == (jc.enriched_dir, jc.ablation, jc.joint)
    assert tc.retrieval.train.train_steps == 6000 and tc.ranking.train.batch_size == 256
    assert [f.name for f in tc.ranking.model.features.tensor_features] == ["user_emb", "item_emb"]


@pytest.fixture(scope="module")
def joint_data(tmp_path_factory):
    """JAX's synth files, the two configs on them, and both encoders with
    JAX's initial weights."""
    root = str(tmp_path_factory.mktemp("joint"))
    jc, tc = _load(tiny_overrides(root))
    jjp._generate_synth(jc)
    jw = JaxWrapper(jc.retrieval.model)
    rs = np.random.RandomState(0)
    example = {"product_ids": rs.randint(-(2**62), 2**62, size=(4, 64)).astype(np.int64),
               "labels": np.zeros((4, 64), np.float32), "timestamps": np.zeros((4, 64), np.float32)}
    vs = jw.init_variables(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in example.items()})
    tw = LTHMModelWrapper(tc.retrieval.model, device="cpu")
    tw.load_jax_variables(jax.tree_util.tree_map(np.asarray, vs))
    return root, jc, tc, jw, vs, tw


def test_synth_stage_writes_jax_files(tmp_path, joint_data):
    root, _, _, _, _, _ = joint_data
    _, tc = _load(tiny_overrides(str(tmp_path)))
    tjp._generate_synth(tc)
    import pyarrow.parquet as pq

    ours = sorted(glob.glob(f"{tmp_path}/data/*/*/*.parquet"))
    theirs = sorted(glob.glob(f"{root}/data/*/*/*.parquet"))
    assert [os.path.relpath(p, tmp_path) for p in ours] == [os.path.relpath(p, root) for p in theirs]
    assert len(ours) == 5
    for a, b in zip(ours, theirs):
        ta, tb = pq.read_table(a).to_pylist(), pq.read_table(b).to_pylist()
        assert ta == tb, a


def test_encode_tables_match_jax(joint_data):
    _, jc, tc, jw, vs, tw = joint_data
    state = JaxTrainState.create(vs["params"], vs.get("constants", {}), {}, None, jax.random.PRNGKey(1))
    with jax.disable_jit():
        want = jjp._encode_tables(jc, jw, state)
    got = tjp._encode_tables(tc, tw)
    # 2 files of 50 users in batches of 16: 48 a file, the last 2 left out
    assert len(got["users"]) == 96 and set(got["users"]) == set(want["users"])
    assert "user_0_49" not in got["users"] and "user_0_47" in got["users"]
    for k, v in want["users"].items():
        np.testing.assert_allclose(got["users"][k], v, rtol=0, atol=F32_TOL, err_msg=k)
    assert set(got["items"]) == set(want["items"])
    for k, v in want["items"].items():
        np.testing.assert_allclose(got["items"][k], v, rtol=0, atol=F32_TOL, err_msg=k)


def test_attach_user_embeddings_as_jax():
    import pandas as pd

    table = tsynth.make_ranking_log(num_rows=32, num_users=16)
    users = {f"user_{i}": np.full(4, i, np.float32) for i in range(8)}
    got = ttools.attach_user_embeddings(table, users, 4)
    want = jtools.attach_user_embeddings(pd.DataFrame({k: list(v) for k, v in table.items()}), users, 4)
    np.testing.assert_array_equal(np.stack(got["user_emb"]), np.stack(want["user_emb"].to_numpy()))
    cold = [i for i, u in enumerate(table["customer_id"]) if u not in users]
    assert cold and np.abs(np.stack(got["user_emb"])[cold]).max() == 0.0


def test_run_joint_trains_with_user_embeddings(joint_data):
    _, _, tc, _, _, tw = joint_data
    from recommendations_tpu_torch.data.data_store import read_parquet_table

    clicks = read_parquet_table(sorted(glob.glob(f"{tc.synth.root}/clicks/*/*.parquet"))[0])
    batches = ttools.user_batches(clicks, tc.retrieval.model.features, 16)
    assert len(batches) == 3 and all(len(b["customer_id"]) == 16 for b in batches)
    d = model_dump(tc.ranking.model)
    d["features"]["tensor_features"] = [{"name": "user_emb", "kind": "tensor", "emb_dim": 32, "tower_name": "user"}]
    rcfg = RankerModelConfig.from_dict(_plain(d))
    impressions = {k: v for k, v in tsynth.make_ranking_log(num_rows=256, num_users=16).items()
                   if k in ("product_id", "customer_id", "price", "click")}
    impressions["customer_id"] = np.asarray([f"user_0_{int(u.split('_')[1])}" for u in impressions["customer_id"]],
                                            dtype=object)
    wrapper, metrics = ttools.run_joint(tw, batches, impressions, rcfg, train_steps=10, batch_size=64, device="cpu")
    assert np.isfinite(metrics["train_loss"]) and 0.0 <= metrics["train_auc_click"] <= 1.0
    assert any(n.startswith("user_tower") for n, _ in wrapper.module.named_parameters())


def test_joint_main_training_end_to_end(tmp_path):
    root = str(tmp_path)
    over = tiny_overrides(root)
    args = ["--config-name", "joint_train", "--device", "cpu"]

    def flat(prefix, d):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(f"{prefix}{k}.", v)
            else:
                yield f"{prefix}{k}={v}"

    _, metrics = main_training.main(args + list(flat("", over)), return_pipeline=True)
    assert {"retrieval", "ranking", "ranking_ablated"} <= set(metrics)
    assert np.isfinite(metrics["ranking"]["val_auc_click"]) and np.isfinite(metrics["ranking_ablated"]["val_auc_click"])
    assert np.isfinite(metrics["auc_uplift_click"])
    assert metrics["ranking"]["train_samples_per_sec"] > 0
    import pyarrow.parquet as pq

    files = glob.glob(f"{root}/enriched/train/*/*.parquet")
    assert files
    t = pq.read_table(files[0])
    assert {"user_emb", "item_emb"} <= set(t.column_names)
    assert len(t.column("user_emb")[0].as_py()) == 32
