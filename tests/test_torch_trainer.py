"""The port's trainer entry point against the JAX package's, on the CPU, on
lthm_tiny.yaml and the same synthetic parquet files: the first 3 training
losses from the same initial weights and lookahead offsets, the jsonl
tracker's keys, the exported config.json; and the port's own run: the loss
falls, validation is logged, a checkpoint resumes to the same bits, the
export serves the same vectors, the in-memory store's run needs none of
pandas, pyarrow, pydantic and xxhash, and the entry point refuses to run
without a card unless told to run on the CPU. Then the rest of the
trainer's knobs: with dropout (JAX's masks replayed), accumulation, two
steps a dispatch, the process reader, grouping under a shuffle buffer,
profile capture and a stats section, the logged losses are JAX's op-by-op
step's; two steps a dispatch give one's bits; a resume through the
iterator snapshot gives the uninterrupted run's bits."""

import json
import logging
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import main_training as jax_main_training
from recommendations_tpu.config.yaml_loader import load_config as jax_load_config
from recommendations_tpu.config.yaml_loader import parse_cli_overrides as jax_parse
from recommendations_tpu.data.generator import get_data_loader_strategy as jax_strategy
from recommendations_tpu.data.loader import get_host_dataloader as jax_loader
from recommendations_tpu.data.paths import get_train_data_paths as jax_train_paths
from recommendations_tpu.models.lthm.loss import sample_offsets as jax_sample_offsets
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxWrapper
from recommendations_tpu.tools import synth_data as jsynth
from recommendations_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from recommendations_tpu.train.train_state import TrainState as JaxTrainState
from recommendations_tpu_torch import main_training
from recommendations_tpu_torch.models.lthm import loss as port_loss
from recommendations_tpu_torch.models.lthm.builder import LTHMModelBuilder
from recommendations_tpu_torch.pipeline.export import load_exported_wrapper

TOL = 1e-4  # the loss, f32: tests/test_torch_train.py's tolerance
PARITY_STEPS = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(root, out, tag, steps, extra=()):
    """lthm_tiny.yaml on ``root``'s parquet files, at float32 compute, with
    the export and the jsonl tracker under ``out``."""
    return [f"dataset.filesystem_config.local_dir_prefix={root}", f"export.filesystem_config.local_dir_prefix={out}",
            f"trackers.trackers=[{{kind: console}}, {{kind: jsonl, path: {out}/{tag}.jsonl}}]",
            f"model_version={tag}", "run_id=r1", f"train.train_steps={steps}", "train.validation_steps=2",
            f"train.val_metrics_every_n_steps={steps}", "train.train_metrics_every_n_steps=1",
            "model.compute_dtype=float32", *extra]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("lthm_tiny_data")
    jsynth.write_synthetic_dataset(str(root), ["20240101", "20240102"], files_per_date=2, users_per_file=64,
                                   history_len=64)
    return str(root)


@pytest.fixture(scope="module")
def jax_run(data_root, tmp_path_factory):
    """JAX's pipeline for PARITY_STEPS steps; the initial variables and
    per-step lookahead offsets its strategy used; and JAX's train step's
    losses from them on the loader's first batches."""
    out = str(tmp_path_factory.mktemp("jax_out"))
    cfg = jax_load_config(os.path.join(REPO, "configs", "lthm_tiny.yaml"),
                          overrides=jax_parse(_args(data_root, out, "jax", PARITY_STEPS)),
                          search_paths=[os.path.join(REPO, "configs")])
    jax_main_training.execute_pipeline(cfg)
    # the strategy's initial variables: init_variables(PRNGKey(0), the first train batch)
    strategy = jax_strategy(cfg.data_loader, cfg.model.features.get_input_columns(), cfg.model.preprocess_fn)
    example = next(iter(jax_loader("train", 0, jax_train_paths(cfg.dataset), cfg.train.batch_size, 1, strategy,
                                   cfg.model.features, cfg.dataset.filesystem_config)))
    variables = JaxWrapper(cfg.model).init_variables(jax.random.PRNGKey(0), example)
    # the strategy's rng: split(PRNGKey(0))[1], then split once a step; the
    # loss draws its offsets from split(step key)[1]
    rng = jax.random.split(jax.random.PRNGKey(0))[1]
    offsets = []
    for _ in range(PARITY_STEPS):
        rng, sub = jax.random.split(rng)
        offsets.append(np.asarray(jax_sample_offsets(jax.random.split(sub)[1], list(cfg.model.lookahead))))
    # JAX's train step run op by op on the first training batches, in the
    # loader's order: compiled, XLA's CPU fusions move the step-1 loss by
    # 3.6e-4 (1.2e-5 relative) here, so the parity tests of the step run
    # JAX op by op (tests/test_torch_train.py)
    jw = JaxWrapper(cfg.model)
    params, constants = variables["params"], variables.get("constants", {})
    optimizer = jax_build_optimizer(jw, cfg.train, params)
    state = JaxTrainState.create(params, constants, optimizer.init(params), jw.init_aux_state(),
                                 jax.random.split(jax.random.PRNGKey(0))[1])
    losses = []
    batches = jax_loader("train", 0, jax_train_paths(cfg.dataset), cfg.train.batch_size, PARITY_STEPS, strategy,
                         cfg.model.features, cfg.dataset.filesystem_config)
    for batch in batches:
        state, loss = _jax_step(jw, optimizer, state, {k: jnp.asarray(v) for k, v in batch.items()
                                                        if v.dtype != object})
        losses.append(float(loss))
    return {"out": out, "variables": jax.tree_util.tree_map(np.asarray, variables), "offsets": offsets,
            "losses": losses}


def _jax_step(jw, optimizer, state, batch):
    """JAX's train step (train/strategy.py:144-234, the dense table path)."""
    rng, sub = jax.random.split(state.rng)

    def loss_fn(p):
        return jw.loss_and_metrics(p, state.constants, state.aux, batch, sub, True)

    (loss, (_, new_aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
    new_state = JaxTrainState(
        params=optax.apply_updates(state.params, updates), constants=state.constants, opt_state=new_opt,
        aux=new_aux, step=state.step + 1, rng=rng, table_state=None,
    )
    return new_state, loss


class _FromJaxBuilder(LTHMModelBuilder):
    """The port's builder, loading JAX's initial variables."""

    def __init__(self, base, variables):
        super().__init__(base.stats, base.model_config, device=base.device)
        self.variables = variables

    def build(self):
        wrapper = super().build()
        wrapper.load_jax_variables(self.variables)
        return wrapper


@pytest.fixture(scope="module")
def port_run(data_root, jax_run, tmp_path_factory):
    """The port's pipeline on the same config and data, from JAX's initial
    variables, its sampler patched to JAX's offsets for the training steps."""
    out = str(tmp_path_factory.mktemp("port_out"))
    cfg = main_training.load_config(os.path.join(REPO, "configs", "lthm_tiny.yaml"),
                                    overrides=main_training.parse_cli_overrides(
                                        _args(data_root, out, "port", PARITY_STEPS)),
                                    search_paths=[str(main_training.CONFIG_ROOT)])
    pipeline = main_training.build_pipeline(cfg, "cpu")
    pipeline.model_builder = _FromJaxBuilder(pipeline.model_builder, jax_run["variables"])
    pending = [o for o in jax_run["offsets"]]
    original = port_loss.sample_offsets

    def jax_offsets(generator, lookahead):
        return torch.from_numpy(pending.pop(0).copy()) if pending else original(generator, lookahead)

    port_loss.sample_offsets = jax_offsets
    try:
        metrics = pipeline.execute()
    finally:
        port_loss.sample_offsets = original
    assert not pending
    return {"out": out, "pipeline": pipeline, "metrics": metrics}


def _metric_lines(records, prefix):
    return [r for r in records if r["event"] == "metrics" and f"{prefix}_loss" in r["metrics"]]


def test_first_losses_match_jax(jax_run, port_run):
    """From JAX's initial variables and JAX's offsets, the port strategy's
    first 3 training losses (the jsonl's train_loss, one line a step) are
    JAX's train step's on the same batches, within 1e-4."""
    got = [r["metrics"]["train_loss"] for r in _metric_lines(_jsonl(f"{port_run['out']}/port.jsonl"), "train")]
    assert len(got) == len(jax_run["losses"]) == PARITY_STEPS
    np.testing.assert_allclose(got, jax_run["losses"], rtol=0, atol=TOL)
    assert got[-1] < got[0]


def test_jsonl_keys_and_steps_equal_jax(jax_run, port_run):
    j, t = _jsonl(f"{jax_run['out']}/jax.jsonl"), _jsonl(f"{port_run['out']}/port.jsonl")
    assert [r["event"] for r in t] == [r["event"] for r in j]
    for rj, rt in zip(j, t):
        assert set(rt) == set(rj)
        if rj["event"] == "params":
            assert set(rt["params"]) == set(rj["params"])
        if rj["event"] == "metrics":
            assert set(rt["metrics"]) == set(rj["metrics"]) and rt["step"] == rj["step"]
    val = _metric_lines(t, "val")
    assert len(val) == 1 and np.isfinite(val[0]["metrics"]["val_loss"])


def test_chip_smoke_expects_jax_metric_keys(jax_run, port_run):
    """The key sets chip_smoke.py holds the card's jsonl to are JAX's."""
    from chip_smoke import expected_metric_keys

    cfg = port_run["pipeline"].pipeline_config.model
    j = _jsonl(f"{jax_run['out']}/jax.jsonl")
    assert set(_metric_lines(j, "train")[0]["metrics"]) == expected_metric_keys(cfg, "train")
    assert set(_metric_lines(j, "val")[0]["metrics"]) == expected_metric_keys(cfg, "val")


def test_export_config_json_equals_jax(jax_run, port_run):
    def exported(out, tag):
        with open(os.path.join(out, "lthm_tiny", "dev", tag, "config.json")) as f:
            return json.load(f)

    assert exported(port_run["out"], "port") == exported(jax_run["out"], "jax")
    assert os.path.exists(os.path.join(port_run["out"], "lthm_tiny", "dev", "port", "params", "state_dict.pt"))


def test_port_trains_validates_resumes_and_exports(data_root, tmp_path):
    """lthm_tiny as the YAML has it (bf16), 8 steps with a checkpoint every
    4: the loss falls, validation metrics are logged; a second run from the
    step-4 checkpoint ends on the same bits; the export serves the same
    user vectors in a fresh wrapper."""
    def run(tag):
        argv = ["--config-name", "lthm_tiny", "--device", "cpu",
                *_args(data_root, str(tmp_path), tag, 8, extra=(
                    "train.checkpoint_every_k_steps=4", f"checkpoint_dir={tmp_path}/ckpt_{tag}",
                    "train.val_metrics_every_n_steps=4", "model.compute_dtype=bfloat16"))]
        return main_training.main(argv, return_pipeline=True)

    pipe_a, metrics_a = run("a")
    losses = [r["metrics"]["train_loss"] for r in _metric_lines(_jsonl(f"{tmp_path}/a.jsonl"), "train")]
    assert len(losses) == 8 and np.isfinite(losses).all() and np.mean(losses[-2:]) < np.mean(losses[:2])
    assert len(_metric_lines(_jsonl(f"{tmp_path}/a.jsonl"), "val")) == 2
    # each checkpoint with the data iterator's snapshot beside it
    assert metrics_a["train_steps_total"] == 8 and sorted(os.listdir(f"{tmp_path}/ckpt_a")) == [
        "data_iter_h0_s4.pkl", "data_iter_h0_s8.pkl", "step_00000004.pt", "step_00000008.pt"]

    os.makedirs(f"{tmp_path}/ckpt_b")
    shutil.copy(f"{tmp_path}/ckpt_a/step_00000004.pt", f"{tmp_path}/ckpt_b/")
    pipe_b, _ = run("b")
    (wa, sa), (wb, sb) = pipe_a._trained, pipe_b._trained
    assert sa.step == sb.step == 8
    da, db = sa.state_dict(), sb.state_dict()
    for name, t in da["module"].items():
        assert torch.equal(t, db["module"][name]), name
    for oa, ob in zip(da["optimizers"], db["optimizers"]):
        for pid, st in oa["state"].items():
            for k, t in st.items():
                assert torch.equal(torch.as_tensor(t), torch.as_tensor(ob["state"][pid][k])), k
    assert torch.equal(sa.aux.logq.b, sb.aux.logq.b) and torch.equal(sa.aux.logq.a, sb.aux.logq.a)
    b_losses = [r["metrics"]["train_loss"] for r in _metric_lines(_jsonl(f"{tmp_path}/b.jsonl"), "train")]
    assert b_losses == losses[4:]

    fresh = load_exported_wrapper(pipe_a.export_dir(), device="cpu")
    rs = np.random.RandomState(0)
    batch = {"product_ids": rs.randint(-(2**62), 2**62, size=(4, 60)).astype(np.int64),
             "labels": np.zeros((4, 60), np.float32), "timestamps": np.zeros((4, 60), np.float32)}
    assert torch.equal(fresh.inference_models()["user_encoder"](batch)["user_emb"],
                       wa.inference_models()["user_encoder"](batch)["user_emb"])


def test_fake_store_run_imports_no_pandas_pyarrow_pydantic_or_xxhash(tmp_path):
    """A subprocess where those four modules cannot be imported trains the
    tiny run from the in-memory store, filled by the port's synth_data."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("pandas", "pyarrow", "pydantic", "xxhash"):
            sys.modules[name] = None  # any import of it raises ImportError
        from recommendations_tpu_torch import main_training
        from recommendations_tpu_torch.data.data_store import FakeDataStore
        from recommendations_tpu_torch.tools.synth_data import write_synthetic_dataset
        write_synthetic_dataset(None, ["20240101", "20240102"], 2, 48, 64, fake_store=True)
        _, metrics = main_training.main([
            "--config-name", "lthm_tiny", "--device", "cpu", "dataset.filesystem_config.kind=fake",
            "export.filesystem_config.local_dir_prefix={tmp_path}", "train.train_steps=3",
            "train.train_metrics_every_n_steps=1", "train.val_metrics_every_n_steps=3",
            "trackers.trackers=[{{kind: jsonl, path: {tmp_path}/m.jsonl}}]"], return_pipeline=True)
        assert metrics["train_steps_total"] == 3, metrics
        assert not any(sys.modules.get(n) for n in ("pandas", "pyarrow", "pydantic", "xxhash", "jax"))
        print("ok", metrics["train_loss"], metrics["val_loss"])
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_entry_point_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main_training.main(["--config-name", "lthm_tiny"])


# -- the rest of the trainer's knobs ---------------------------------------------

KNOB_STEPS = 4
# every knob of the single-process trainer at once (debug_numerics, which
# turns steps_per_dispatch off, is tests/test_torch_debug.py's): dropout,
# accumulation, two steps a dispatch, the process reader, grouping by a
# column of the synth rows with repeated values (product_id, the last item
# of a history) under a shuffle buffer, profile capture and a stats section
KNOBS = ("model.transformer_config.attn_config.dropout=0.1", "model.transformer_config.attn_config.attn_dropout=0.1",
         "train.gradient_accumulation_steps=2", "train.steps_per_dispatch=2", "data_loader.bypass_dataloader=false",
         "data_loader.process_reader=true", "data_loader.shuffle_buffer_num_mini_batches=2",
         "model.features.group_dataset={group_by_columns: [product_id], sort_by_columns: [customer_id], "
         "minimum_group_size: 1}", "stats={compute_stats: true}")


def _jax_step_with_masks(jw, optimizer, state, batch, masks):
    """``_jax_step``, with the dropout masks its forward draws appended to
    ``masks`` in order (tests/test_torch_dropout.py's recording)."""
    import flax.linen as fnn
    from recommendations_tpu.nn import attention as jatt

    real = jatt._token_dropout_mask

    def token_mask(key, rate, b, t):
        out = real(key, rate, b, t)
        masks.append(np.asarray(out) > 0)
        return out

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, fnn.Dropout) or context.method_name != "__call__" or \
                kwargs.get("deterministic", mod.deterministic) or mod.rate in (0.0, 1.0):
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = np.asarray(next_fun(jnp.ones_like(x), *args[1:], **kwargs)) != 0
        masks.append(keep)
        return jax.lax.select(jnp.asarray(keep), x / (1.0 - mod.rate), jnp.zeros_like(x))

    jatt._token_dropout_mask = token_mask
    try:
        with fnn.intercept_methods(interceptor):
            return _jax_step(jw, optimizer, state, batch)
    finally:
        jatt._token_dropout_mask = real


@pytest.fixture(scope="module")
def knob_runs(data_root, tmp_path_factory):
    """JAX's first KNOB_STEPS steps under every knob, run op by op on its
    loader's batches with its dropout masks recorded; and the port's
    main_training on the same config from JAX's initial variables with
    JAX's offsets and masks."""
    from recommendations_tpu_torch.nn import dropout as tdrop

    out = str(tmp_path_factory.mktemp("knob_out"))
    args = _args(data_root, out, "knobs", KNOB_STEPS, extra=KNOBS + (
        f"training_strategy.profile_dir={out}/profile", "training_strategy.profile_start_step=1",
        "training_strategy.profile_num_steps=2"))
    # JAX's batches from its thread reader: its process reader forks this
    # multi-threaded process (the port's spawns); both yield the same batches
    jargs = [a for a in args if a != "data_loader.process_reader=true"]
    jcfg = jax_load_config(os.path.join(REPO, "configs", "lthm_tiny.yaml"), overrides=jax_parse(jargs),
                           search_paths=[os.path.join(REPO, "configs")])
    strategy = jax_strategy(jcfg.data_loader, jcfg.model.features.get_input_columns(), jcfg.model.preprocess_fn)

    def loader(n):
        return jax_loader("train", 0, jax_train_paths(jcfg.dataset), jcfg.train.batch_size, n, strategy,
                          jcfg.model.features, jcfg.dataset.filesystem_config)

    example = next(iter(loader(1)))
    jw = JaxWrapper(jcfg.model)
    variables = jw.init_variables(jax.random.PRNGKey(0), example)
    params, constants = variables["params"], variables.get("constants", {})
    optimizer = jax_build_optimizer(jw, jcfg.train, params)  # optax.MultiSteps(k=2)
    state = JaxTrainState.create(params, constants, optimizer.init(params), jw.init_aux_state(),
                                 jax.random.split(jax.random.PRNGKey(0))[1])
    losses, offsets, masks = [], [], []
    for batch in loader(KNOB_STEPS):
        _, sub = jax.random.split(state.rng)
        offsets.append(np.asarray(jax_sample_offsets(jax.random.split(sub)[1], list(jcfg.model.lookahead))))
        state, loss = _jax_step_with_masks(jw, optimizer, state, {k: jnp.asarray(v) for k, v in batch.items()
                                                                   if v.dtype != object}, masks)
        losses.append(float(loss))
    assert len(losses) == KNOB_STEPS

    cfg = main_training.load_config(os.path.join(REPO, "configs", "lthm_tiny.yaml"),
                                    overrides=main_training.parse_cli_overrides(args),
                                    search_paths=[str(main_training.CONFIG_ROOT)])
    pipeline = main_training.build_pipeline(cfg, "cpu")
    pipeline.model_builder = _FromJaxBuilder(pipeline.model_builder, jax.tree_util.tree_map(np.asarray, variables))
    pending_offsets, pending_masks = list(offsets), list(masks)
    original_offsets, original_keep = port_loss.sample_offsets, tdrop.dropout_keep

    def jax_offsets(generator, lookahead):  # validation draws its own
        return torch.from_numpy(pending_offsets.pop(0).copy()) if pending_offsets else \
            original_offsets(generator, lookahead)

    def jax_keep(generator, keep_prob, shape, device):
        mask = pending_masks.pop(0)
        assert tuple(mask.shape) == tuple(shape)
        return torch.from_numpy(mask.copy())

    port_loss.sample_offsets, tdrop.dropout_keep = jax_offsets, jax_keep
    try:
        metrics = pipeline.execute()
    finally:
        port_loss.sample_offsets, tdrop.dropout_keep = original_offsets, original_keep
    assert not pending_offsets and not pending_masks
    return {"out": out, "jax_losses": losses, "metrics": metrics, "pipeline": pipeline}


def test_every_knob_gives_jax_losses(knob_runs):
    """With dropout (JAX's masks), k = 2 accumulation (optax.MultiSteps), two
    steps a dispatch, the process reader, grouping and the shuffle buffer,
    the port's logged losses (one a dispatch group: steps 2 and 4) are JAX's
    op-by-op step's on the same batches, within 1e-4."""
    records = _metric_lines(_jsonl(f"{knob_runs['out']}/knobs.jsonl"), "train")
    assert [r["metrics"]["steps"] for r in records] == [2, 4]
    got = [r["metrics"]["train_loss"] for r in records]
    np.testing.assert_allclose(got, [knob_runs["jax_losses"][1], knob_runs["jax_losses"][3]], rtol=0, atol=TOL)
    assert knob_runs["metrics"]["train_steps_total"] == KNOB_STEPS


def test_profile_capture_writes_a_chrome_trace(knob_runs):
    """profile_dir: torch.profiler over steps 1-3 (a dispatch group of 2
    crosses step 3), its Chrome trace under profile_dir naming the step's
    phases."""
    prof = os.path.join(knob_runs["out"], "profile")
    files = os.listdir(prof)
    assert files == ["torch_trace_steps_2_4.json"]
    with open(os.path.join(prof, files[0])) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"lthm/forward", "lthm/loss", "lthm/backward", "lthm/optimizer"} <= names


def _knob_run(root, out, tag, steps, extra=()):
    argv = ["--config-name", "lthm_tiny", "--device", "cpu",
            *_args(root, out, tag, steps, extra=KNOBS[:-1] + tuple(extra))]
    return main_training.main(argv, return_pipeline=True)


def _same_state(sa, sb):
    da, db = sa.state_dict(), sb.state_dict()
    for name, t in da["module"].items():
        assert torch.equal(t, db["module"][name]), name
    for oa, ob in zip(da["optimizers"], db["optimizers"]):
        for pid, st in oa["state"].items():
            for k, t in st.items():
                assert torch.equal(torch.as_tensor(t), torch.as_tensor(ob["state"][pid][k])), k
    assert da["accumulation"]["mini_step"] == db["accumulation"]["mini_step"]
    assert torch.equal(sa.aux.logq.b, sb.aux.logq.b) and torch.equal(sa.aux.logq.a, sb.aux.logq.a)
    assert sa.step == sb.step
    assert torch.equal(sa.dropout_generator.get_state(), sb.dropout_generator.get_state())


def test_two_steps_a_dispatch_equal_one(data_root, tmp_path):
    """steps_per_dispatch 2 ends on the bits of 1 over the same steps
    (tests/test_multi_dispatch.py:103); the step count rounds up to a whole
    group, as JAX's."""
    pipe_2, m2 = _knob_run(data_root, str(tmp_path), "k2", 5)
    pipe_1, m1 = _knob_run(data_root, str(tmp_path), "k1", 6, extra=("train.steps_per_dispatch=1",))
    assert m2["train_steps_total"] == m1["train_steps_total"] == 6
    _same_state(pipe_2._trained[1], pipe_1._trained[1])
    assert m2["train_loss"] == m1["train_loss"]


def test_resume_through_the_snapshot_equals_the_uninterrupted_run(data_root, tmp_path, caplog):
    """Grouped, shuffle-buffered, process-read, with dropout and accumulation
    (a checkpoint at step 4 sits between two accumulations' emits when k
    is 3): resumed from step 4's checkpoint and its iterator snapshot, the
    run ends on the uninterrupted run's bits, restoring the snapshot and
    never replaying (tests/test_trainer_resume.py:190)."""
    extra = ("train.checkpoint_every_k_steps=4", "train.gradient_accumulation_steps=3")
    pipe_a, _ = _knob_run(data_root, str(tmp_path), "a", 8, extra=extra + (f"checkpoint_dir={tmp_path}/ckpt_a",))
    assert sorted(os.listdir(f"{tmp_path}/ckpt_a")) == [
        "data_iter_h0_s4.pkl", "data_iter_h0_s8.pkl", "step_00000004.pt", "step_00000008.pt"]
    os.makedirs(f"{tmp_path}/ckpt_b")
    for name in ("step_00000004.pt", "data_iter_h0_s4.pkl"):
        shutil.copy(f"{tmp_path}/ckpt_a/{name}", f"{tmp_path}/ckpt_b/")
    with caplog.at_level(logging.INFO, logger="recommendations_tpu_torch.train.strategy"):
        pipe_b, _ = _knob_run(data_root, str(tmp_path), "b", 8, extra=extra + (f"checkpoint_dir={tmp_path}/ckpt_b",))
    messages = [r.message for r in caplog.records]
    assert any("restored data-iterator snapshot at epoch 0 batch 4" in m for m in messages), messages
    assert not any("(replay)" in m for m in messages)
    _same_state(pipe_a._trained[1], pipe_b._trained[1])


def test_bypassed_loader_resumes_through_the_metadata_skip(data_root, tmp_path, caplog):
    """With ``bypass_dataloader`` (lthm_train.yaml's setting) the batcher is
    the loader; a resume skips the consumed rows by file metadata once and
    ends on the uninterrupted run's bits. (The JAX package returns the
    bypassed dataset before marking the skip, so it would replay on top of
    the skip: ROADMAP section 3.)"""
    def run(tag, ckpt):
        argv = ["--config-name", "lthm_tiny", "--device", "cpu", *_args(data_root, str(tmp_path), tag, 6, extra=(
            "data_loader.bypass_dataloader=true", "train.checkpoint_every_k_steps=3", f"checkpoint_dir={ckpt}"))]
        return main_training.main(argv, return_pipeline=True)[0]._trained[1]

    full = run("a", f"{tmp_path}/ckpt_a")
    os.makedirs(f"{tmp_path}/ckpt_b")
    shutil.copy(f"{tmp_path}/ckpt_a/step_00000003.pt", f"{tmp_path}/ckpt_b/")
    with caplog.at_level(logging.INFO, logger="recommendations_tpu_torch.train.strategy"):
        resumed = run("b", f"{tmp_path}/ckpt_b")
    messages = [r.message for r in caplog.records]
    assert any("batch 3 (metadata skip)" in m for m in messages), messages
    assert not any("(replay)" in m for m in messages)
    _same_state(full, resumed)
