"""The port's traced export programs and batch inference against the JAX
package's, on the CPU (f32 lthm_tiny, the same weights through
``load_jax_variables``, numpy-seeded inputs):

- each ``<name>.pt2`` program, loaded with ``torch.export.load``, gives the
  eager port's outputs bit for bit, and JAX's deserialized ``.stablehlo``
  program's within 2e-5 (f32) on the same batch;
- a traced forward through the bias kernel keeps the custom operator
  (its fake implementation gives the trace its shapes) and the program
  gives the eager bits;
- ``run_inference``'s parquet has JAX's columns and rows (the last partial
  batch's pad rows dropped), each value within 2e-5 of JAX's (f32), for
  LTHM (per-user vectors) and the ranker (per-impression task scores);
- ``main_training`` on lthm_tiny with the KNN eval, the batch inference and
  the traced export writes knn_eval.csv, inference_results.parquet and the
  two programs, and ``skip_train`` builds an untrained wrapper and writes
  none of them.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from recommendations_tpu.config.yaml_loader import load_config as jax_load_config
from recommendations_tpu.config.yaml_loader import parse_cli_overrides as jax_parse
from recommendations_tpu.data import FakeDataStore as JaxFake
from recommendations_tpu.models.lthm.config import LTHMModelConfig as JaxConfig
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxWrapper
from recommendations_tpu.models.ranker.wrapper import RankerModelWrapper as JaxRanker
from recommendations_tpu.pipeline import export as jexport
from recommendations_tpu.pipeline import inference as jinference
from recommendations_tpu.train.train_state import TrainState as JaxTrainState
from recommendations_tpu_torch import main_training
from recommendations_tpu_torch.config.yaml_loader import load_config, parse_cli_overrides
from recommendations_tpu_torch.data.data_store import FakeDataStore
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.models.ranker.wrapper import RankerModelWrapper
from recommendations_tpu_torch.ops import fused_attention as fa
from recommendations_tpu_torch.pipeline import export as texport
from recommendations_tpu_torch.pipeline import inference as tinference
from recommendations_tpu_torch.tools import synth_data as tsynth
from tests.test_torch_config_loader import CONFIG_ROOT

F32_TOL = 2e-5


def tiny_dict() -> dict:
    with open(CONFIG_ROOT / "model" / "lthm_tiny.yaml") as f:
        d = yaml.safe_load(f)
    d["compute_dtype"] = "float32"
    return d


def batch_of(b=6, s=64, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(-(2**62), 2**62, size=(b, s)).astype(np.int64)
    for i in range(b):
        ids[i, s - rs.randint(0, s // 2):] = 0
    return {"product_ids": ids, "labels": rs.randint(0, 4, size=(b, s)).astype(np.float32),
            "timestamps": rs.randint(1_600_000_000, 1_700_000_000, size=(b, s)).astype(np.float32)}


@pytest.fixture(scope="module")
def lthm():
    d = tiny_dict()
    jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
    vs = jw.init_variables(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch_of().items()})
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
    tw.load_jax_variables(jax.tree_util.tree_map(np.asarray, vs))
    return jw, vs, tw


def _jax_state(vs):
    return JaxTrainState.create(vs.get("params", {}), vs.get("constants", {}), {}, None, jax.random.PRNGKey(1))


def test_pt2_programs_match_the_eager_port_and_jax_stablehlo(tmp_path, lthm):
    from jax import export as jax_export

    jw, vs, tw = lthm
    trace = batch_of(seed=1)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jexport.export_model_artifacts(jw, _jax_state(vs), str(jdir), trace_batch=trace)
    texport.export_model_artifacts(tw, str(tdir), trace_batch={**trace, "customer_id": np.array(
        [f"u{i}" for i in range(6)], dtype=object)})
    assert sorted(os.listdir(tdir)) == ["config.json", "params", "sequence_encoder.pt2", "user_encoder.pt2"]
    for name in ("user_encoder", "sequence_encoder"):
        program = texport.load_inference_program(str(tdir), name, device="cpu")
        got = program(trace)
        eager = tw.inference_models()[name](trace)
        assert set(got) == set(eager)
        for k in eager:
            assert torch.equal(got[k], eager[k]), (name, k)
        exported = jax_export.deserialize((jdir / f"{name}.stablehlo").read_bytes())
        want = exported.call({"params": vs["params"], "constants": vs["constants"]},
                             {k: jnp.asarray(v) for k, v in trace.items()})
        for k in want:
            w = np.asarray(want[k])
            if w.dtype.kind == "f":
                np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=F32_TOL, err_msg=f"{name}.{k}")
            else:
                np.testing.assert_array_equal(got[k].numpy(), w, err_msg=f"{name}.{k}")
    # the program carries no weights of its own: they are its input
    assert os.path.getsize(tdir / "user_encoder.pt2") < os.path.getsize(tdir / "params" / "state_dict.pt")


def test_traced_bias_forward_keeps_the_kernel_operator(tmp_path):
    """T = window = BIAS_MIN_SEQ: on the CPU too the layer takes the fused
    bias path, whose operator the program keeps (on the card the loaded
    program launches flash_bias_fwd through it)."""
    d = tiny_dict()
    d["context_width"] = fa.BIAS_MIN_SEQ - 1
    d["transformer_config"].update(num_layers=1, use_flash_attention=True)
    d["transformer_config"]["attn_config"]["pos_bias"] = {"context_window": fa.BIAS_MIN_SEQ}
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(d), device="cpu")
    batch = batch_of(b=2, s=fa.BIAS_MIN_SEQ - 1, seed=2)
    texport.export_programs(tw, str(tmp_path), batch)
    program = torch.export.load(str(tmp_path / "user_encoder.pt2"))
    targets = [str(n.target) for m in program.graph_module.modules() if hasattr(m, "graph") for n in m.graph.nodes]
    assert any("flash_attention_bias" in t for t in targets)
    out = program.module()(dict(tw.module.state_dict()), texport.program_inputs(batch, "cpu"))
    assert torch.equal(out["user_emb"], tw.inference_models()["user_encoder"](batch)["user_emb"])


def _click_tables(users=40, files=2, seed=0):
    return [tsynth._pad_lists(tsynth.make_click_log(num_users=users, history_len=64, seed=seed + i), 64)
            for i in range(files)]


def _frame(table):
    return pd.DataFrame({k: list(v) for k, v in table.items()})


def _read(path):
    import pyarrow.parquet as pq

    return pq.read_table(path).to_pandas()


def _assert_same_parquet(got_path, want_path):
    got, want = _read(got_path), _read(want_path)
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for col in want.columns:
        w, g = want[col].to_numpy(), got[col].to_numpy()
        if w.dtype == object and isinstance(w[0], np.ndarray):
            w, g = np.stack(w), np.stack(g)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL, err_msg=col)
        else:
            np.testing.assert_array_equal(g, w, err_msg=col)


def test_run_inference_matches_jax(tmp_path, lthm):
    """lthm_tiny.yaml's inference over 2 files of 40 users in batches of 24:
    the last batch of each file is padded to 24 and its pad rows dropped."""
    jw, vs, tw = lthm
    args = ["dataset.filesystem_config={kind: fake, path_template: 'date={date}'}", "inference.skip_inference=false",
            "inference.inference_batch_size=24", "model.compute_dtype=float32"]
    JaxFake.reset()
    FakeDataStore.reset()
    try:
        for i, table in enumerate(_click_tables()):
            JaxFake.put_table(f"date=20240102/part-{i}.parquet", _frame(table))
            FakeDataStore.put_table(f"date=20240102/part-{i}.parquet", table)
        jcfg = jax_load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=jax_parse(args),
                               search_paths=[str(CONFIG_ROOT)])
        tcfg = load_config(CONFIG_ROOT / "lthm_tiny.yaml", overrides=parse_cli_overrides(args),
                           search_paths=[str(CONFIG_ROOT)])
        want = jinference.run_inference(jw, _jax_state(vs), jcfg, str(tmp_path / "jax"))
        got = tinference.run_inference(tw, tcfg, str(tmp_path / "port"))
        assert len(_read(got)) == 80
        assert {"user_encoder.user_emb", "sequence_encoder.current_token_ids", "customer_id"} <= set(_read(got).columns)
        _assert_same_parquet(got, want)
        tcfg.inference.skip_inference = True
        assert tinference.run_inference(tw, tcfg, str(tmp_path / "none")) is None
    finally:
        JaxFake.reset()
        FakeDataStore.reset()


def test_ranker_run_inference_matches_jax(tmp_path):
    """ranker_train.yaml's batch inference: per-impression task scores from
    the same weights, 2 files of 300 rows in batches of 256."""
    args = ["dataset.filesystem_config.kind=fake", "inference.inference_batch_size=256"]
    jcfg = jax_load_config(CONFIG_ROOT / "ranker_train.yaml", overrides=jax_parse(args), search_paths=[str(CONFIG_ROOT)])
    tcfg = load_config(CONFIG_ROOT / "ranker_train.yaml", overrides=parse_cli_overrides(args),
                       search_paths=[str(CONFIG_ROOT)])
    JaxFake.reset()
    FakeDataStore.reset()
    try:
        tables = [tsynth.make_ranking_log(num_rows=300, seed=s) for s in (5, 6)]
        for i, table in enumerate(tables):
            JaxFake.put_table(f"date=20240102/part-{i}.parquet", _frame(table))
            FakeDataStore.put_table(f"date=20240102/part-{i}.parquet", table)
        jw = JaxRanker(jcfg.model)
        mapped = tcfg.model.features.default_data_mapper(dict(tables[0]))
        example = {k: jnp.asarray(np.asarray(v)[:8]) for k, v in mapped.items() if np.asarray(v).dtype.kind in "ifub"}
        vs = jw.init_variables(jax.random.PRNGKey(0), example)
        tw = RankerModelWrapper(tcfg.model, device="cpu")
        tw.load_jax_variables(jax.tree_util.tree_map(np.asarray, vs))
        want = jinference.run_inference(jw, _jax_state(vs), jcfg, str(tmp_path / "jax"))
        got = tinference.run_inference(tw, tcfg, str(tmp_path / "port"))
        res = _read(got)
        assert len(res) == 600 and {"ranker_scorer.click", "ranker_scorer.conversion"} <= set(res.columns)
        _assert_same_parquet(got, want)
    finally:
        JaxFake.reset()
        FakeDataStore.reset()


def test_main_training_runs_eval_inference_and_traced_export(tmp_path):
    """lthm_tiny.yaml from parquet on the CPU with eval.skip_eval=false
    eval.skip_knn_eval=false inference.skip_inference=false
    export.trace=true; then skip_train."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    root, out = tmp_path / "data", tmp_path / "out"
    tsynth.write_synthetic_dataset(str(root), ["20240101", "20240102"], files_per_date=2, users_per_file=48,
                                   history_len=64)
    pq.write_table(pa.table({"product_id": [f"sku_{i}" for i in range(2000)]}), str(tmp_path / "catalog.parquet"))
    common = ["--config-name", "lthm_tiny", "--device", "cpu", f"dataset.filesystem_config.local_dir_prefix={root}",
              f"export.filesystem_config.local_dir_prefix={out}", "trackers.trackers=[{kind: console}]",
              "train.train_steps=4", "train.validation_steps=1", "eval.skip_eval=false", "eval.skip_knn_eval=false",
              "inference.skip_inference=false", "export.trace=true", "model.compute_dtype=float32",
              f"eval.knn_catalog_table_path={tmp_path / 'catalog.parquet'}"]
    pipe, _ = main_training.main(common + ["model_version=a"], return_pipeline=True)
    export = out / "lthm_tiny" / "dev" / "a"
    for f in ("knn_eval.csv", "inference/inference_results.parquet", "user_encoder.pt2", "sequence_encoder.pt2",
              "config.json", "params/state_dict.pt"):
        assert (export / f).exists(), f
    with open(export / "knn_eval.csv") as f:
        rows = f.read().splitlines()
    assert rows[0] == "k,recall,queries" and len(rows) == 1 + 6
    assert len(_read(export / "inference" / "inference_results.parquet")) == 96
    wrapper = pipe._trained[0]
    trace = {k: v for k, v in pipe._trace_batch.items() if v.dtype != object}
    assert len(next(iter(trace.values()))) == 16  # data_loader.mini_batch_size
    got = texport.load_inference_program(str(export), "user_encoder", device="cpu")(trace)
    assert torch.equal(got["user_emb"], wrapper.inference_models()["user_encoder"](trace)["user_emb"])

    pipe_s, metrics = main_training.main(common + ["model_version=s", "train.skip_train=true"], return_pipeline=True)
    assert metrics == {} and pipe_s._trained[1] is None and isinstance(pipe_s._trained[0], LTHMModelWrapper)
    # the eval's export (as JAX's) uploads an empty directory: no file
    assert not [p for p in (out / "lthm_tiny" / "dev").rglob("*") if p.is_file() and "/s/" in str(p)]
