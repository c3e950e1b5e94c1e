"""Data-parallel training in the port: ``main_training`` on lthm_tiny.yaml
over 2 gloo worker processes (one node, 16 of its 32 rows a rank) against
the JAX package's train step (op by op) on the same global batch, from the
same initial weights and lookahead offsets, with the loss chunk spanning
both ranks (``train_mini_batch_size`` -1): the first step's loss (1e-4)
and its gradients summed over the ranks (2e-4), and the losses of the next
steps (1e-4) and the parameters after three (2e-4). With chunks of 16
within each rank, one step is held to the port's one-process step
(chunked, JAX's scan is compiled on the CPU, so ``tests/test_torch_loss.py``
holds the chunked loss to JAX op by op).

Limits of parity (ROADMAP section 3). The LSH direction tables take their
gradients from bf16 one-hot products (JAX ``nn/lsh.py``, bf16 even at a
float32 compute dtype): each rank rounds its rows' partial sum to bf16
and the ranks add the partials, where one process rounds the whole sum
once, so those gradients agree to two bf16 roundings (BF16_GRAD_RTOL), as
JAX's own step over two devices would. Adam's first update moves each
element by lr * g / (|g| + eps), so an element whose gradient cancels to
rounding noise (the LSH direction tables' gradients come from bf16
products, whose partial sums the ranks round apart) moves by up to lr
either way. Such elements (|g| below NOISE in JAX's first gradient) are
left out of the parameter comparison; where one of them flips, the next
losses move by up to LR_FLIP_LOSS, and the run says how many flipped.

Then the strategy's
cooperative parts: rank 0 alone logs and checkpoints while each rank
writes its iterator snapshot; with the table's rows split over model = 2
and trained, rank 0's step-2 checkpoint holds the whole table and a resume
from it ends on the uninterrupted run's bits; with one rank a node (each
reading its own files) the ranks stop together when the shorter shard
runs out."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

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
from recommendations_tpu_torch.config.yaml_loader import load_config
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.models.lthm.model import LTHMEncoder
import torch_dist_worker
from torch_dist import start_workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
STEPS = 3
LOSS_TOL = 1e-4  # tests/test_torch_trainer.py's
GRAD_TOL = 2e-4
PARAM_TOL = 2e-4
BF16_GRAD = "product_tower.direction_emb_"  # gradients of bf16 products
BF16_GRAD_RTOL = 2.0 ** -7  # two bf16 roundings
NOISE = 1e-5  # a first gradient this small: Adam's first step is rounding's sign
LR_FLIP_LOSS = 1e-3  # lthm_tiny's lr: what one flipped element can move a loss by


def _args(root, out, tag, steps, extra=()):
    """lthm_tiny.yaml on ``root``'s files at float32 compute, the export and
    the jsonl tracker under ``out``."""
    return [f"dataset.filesystem_config.local_dir_prefix={root}", f"export.filesystem_config.local_dir_prefix={out}",
            f"trackers.trackers=[{{kind: jsonl, path: {out}/{tag}.jsonl}}]",
            f"model_version={tag}", "run_id=r1", f"train.train_steps={steps}", "train.validation_steps=2",
            f"train.val_metrics_every_n_steps={steps}", "train.train_metrics_every_n_steps=1",
            "model.compute_dtype=float32", *extra]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _train_losses(path):
    return [r["metrics"]["train_loss"] for r in _jsonl(path)
            if r["event"] == "metrics" and "train_loss" in r["metrics"]]


def _jax_cfg(root, out, extra=()):
    return jax_load_config(os.path.join(REPO, "configs", "lthm_tiny.yaml"),
                           overrides=jax_parse(_args(root, out, "jax", STEPS, extra)),
                           search_paths=[os.path.join(REPO, "configs")])


def _jax_start(cfg):
    """The JAX strategy's initial variables and its lookahead offsets."""
    strategy = jax_strategy(cfg.data_loader, cfg.model.features.get_input_columns(), cfg.model.preprocess_fn)
    example = next(iter(jax_loader("train", 0, jax_train_paths(cfg.dataset), cfg.train.batch_size, 1, strategy,
                                   cfg.model.features, cfg.dataset.filesystem_config)))
    variables = JaxWrapper(cfg.model).init_variables(jax.random.PRNGKey(0), example)
    rng = jax.random.split(jax.random.PRNGKey(0))[1]
    offsets = []
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        offsets.append(np.asarray(jax_sample_offsets(jax.random.split(sub)[1], list(cfg.model.lookahead))))
    return variables, offsets, strategy


def _jax_steps(cfg, variables, strategy, steps):
    """JAX's train step, op by op, on the global batches: losses, the first
    step's gradients and the parameters after the steps. With chunks of
    the batch its loss scans them, which compiles: then ``jax.disable_jit``
    (compiled on the CPU, XLA drops the bf16 logits storage, ROADMAP
    section 3)."""
    if cfg.model.train_mini_batch_size > 0:
        with jax.disable_jit():
            return _jax_steps_op_by_op(cfg, variables, strategy, steps)
    return _jax_steps_op_by_op(cfg, variables, strategy, steps)


def _jax_steps_op_by_op(cfg, variables, strategy, steps):
    jw = JaxWrapper(cfg.model)
    params, constants = variables["params"], variables.get("constants", {})
    optimizer = jax_build_optimizer(jw, cfg.train, params)
    state = JaxTrainState.create(params, constants, optimizer.init(params), jw.init_aux_state(),
                                 jax.random.split(jax.random.PRNGKey(0))[1])
    losses = []
    for batch in jax_loader("train", 0, jax_train_paths(cfg.dataset), cfg.train.batch_size, steps, strategy,
                            cfg.model.features, cfg.dataset.filesystem_config):
        b = {k: jnp.asarray(v) for k, v in batch.items() if v.dtype != object}
        rng, sub = jax.random.split(state.rng)

        def loss_fn(p):
            return jw.loss_and_metrics(p, state.constants, state.aux, b, sub, True)

        (loss, (_, new_aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        if not losses:
            first = {"params": jax.tree_util.tree_map(np.asarray, grads),
                     "constants": jax.tree_util.tree_map(lambda c: np.zeros_like(np.asarray(c)), state.constants)}
        updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
        state = JaxTrainState(params=optax.apply_updates(state.params, updates), constants=state.constants,
                              opt_state=new_opt, aux=new_aux, step=state.step + 1, rng=rng, table_state=None)
        losses.append(float(loss))
    return losses, first, {"params": jax.tree_util.tree_map(np.asarray, state.params),
                           "constants": jax.tree_util.tree_map(np.asarray, state.constants)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_data"))
    jsynth.write_synthetic_dataset(root, ["20240101", "20240102"], files_per_date=2, users_per_file=64,
                                   history_len=64)
    # 3 files on the training day: one node reads 2 of them, the other 1
    uneven = str(tmp_path_factory.mktemp("dp_uneven"))
    jsynth.write_synthetic_dataset(uneven, ["20240101", "20240102"], files_per_date=3, users_per_file=64,
                                   history_len=64)
    out = str(tmp_path_factory.mktemp("dp_out"))
    ckpt = os.path.join(out, "ckpt")
    spans_cfg = _jax_cfg(root, out)
    variables, offsets, strategy = _jax_start(spans_cfg)
    np_vars = jax.tree_util.tree_map(np.asarray, variables)
    ckpt_args = [f"checkpoint_dir={ckpt}", "train.checkpoint_every_k_steps=2"]
    # the table's rows over model = 2, trained (rowwise_adam): its blocks and
    # their moments gathered into rank 0's checkpoint, cut again at the resume
    sharded_args = ["training_strategy.mesh_model=2", "model.shard_embedding_rows=true",
                    "model.product_tower.detach_item_tower=false"]
    jobs = [
        ("spans", "train", dict(args=["--config-name", "lthm_tiny", *_args(root, out, "spans", STEPS, ckpt_args)],
                                variables=np_vars, offsets=offsets)),
        ("within", "train", dict(args=["--config-name", "lthm_tiny", *_args(
            root, out, "within", 1, ["model.train_mini_batch_size=16", "training_strategy.mesh_data=2",
                                     "train.num_workers=2"])],
            variables=np_vars, offsets=offsets)),
        *((tag, "train", dict(
            args=["--config-name", "lthm_tiny", *_args(root, out, tag, STEPS, sharded_args + [
                f"checkpoint_dir={ckpt}_{tag}", "train.checkpoint_every_k_steps=2"])],
            copy_checkpoints=(f"{ckpt}_sharded", f"{ckpt}_{tag}") if tag.endswith("resumed") else None))
          for tag in ("sharded", "sharded_resumed")),
        ("two_nodes", "train", dict(args=["--config-name", "lthm_tiny", *_args(
            uneven, out, "two_nodes", 1000, ["train.epochs=1", "train.train_metrics_every_n_steps=1000"])],
            env={"LOCAL_WORLD_SIZE": "1"})),
    ]
    workers = start_workers(jobs, WORLD, timeout=240)
    spans = _jax_steps(spans_cfg, variables, strategy, STEPS)
    one = torch_dist_worker.CASES["train"](args=["--config-name", "lthm_tiny", *_args(
        root, out, "within_one", 1, ["model.train_mini_batch_size=16"])], variables=np_vars, offsets=offsets)
    ranks = workers.results()
    return {"ranks": ranks, "out": out, "ckpt": ckpt, "jax": {"spans": spans}, "one": one, "uneven": uneven}


def _held_to(runs, run, losses, first, want):
    """``run``'s first summed gradients, parameters (both ranks' bits equal)
    and jsonl losses held to a reference's (see the module docstring)."""
    r0, r1 = (r[run] for r in runs["ranks"])
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k], err_msg=k)
    for k, g in r0["first_grads"].items():
        if g is not None:
            rtol = BF16_GRAD_RTOL if k.startswith(BF16_GRAD) else GRAD_TOL
            np.testing.assert_allclose(g, first[k], rtol=rtol, atol=GRAD_TOL, err_msg=k)
    assert set(want) == set(r0["params"])
    flipped = 0
    for k, v in want.items():
        trained = r0["first_grads"].get(k) is not None
        keep = ~(np.abs(first[k]) < NOISE) if trained else np.ones(v.shape, bool)
        np.testing.assert_allclose(r0["params"][k][keep], v[keep], rtol=PARAM_TOL, atol=PARAM_TOL, err_msg=k)
        flipped += int((np.abs(r0["params"][k] - v) > PARAM_TOL).sum())
    logged = _train_losses(os.path.join(runs["out"], f"{run}.jsonl"))
    assert len(logged) == len(losses)  # rank 0's lines only
    np.testing.assert_allclose(logged[0], losses[0], rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(logged[1:], losses[1:], rtol=0, atol=LR_FLIP_LOSS if flipped else LOSS_TOL,
                               err_msg=f"{flipped} noise-level elements took the other Adam step")


def test_chunk_spanning_the_ranks_matches_jax(runs):
    """lthm_tiny's whole-batch chunk over 2 ranks: JAX's losses of 3 steps,
    its first gradients and its parameters after them."""
    losses, jax_first, jax_state = runs["jax"]["spans"]
    _held_to(runs, "spans", losses, _by_port_key(jax_first), _by_port_key(jax_state))


def test_chunks_within_the_ranks_match_one_process(runs):
    """Chunks of 16 users, each on one rank (``mesh_data`` 2 and
    ``num_workers`` 2 set, which JAX's strategy reads from its runtime and
    the port from the process group): the one-process step's loss, first
    gradients and parameters."""
    one = runs["one"]
    losses = _train_losses(os.path.join(runs["out"], "within_one.jsonl"))
    first = {k: g for k, g in one["first_grads"].items() if g is not None}
    want = dict(one["params"])
    for k, v in want.items():
        first.setdefault(k, np.zeros_like(v))
    _held_to(runs, "within", losses, first, want)


def _by_port_key(jax_state):
    """JAX's parameters and constants (or their gradients and zeros) under
    the port's state-dict keys."""
    cfg = load_config(os.path.join(REPO, "configs", "lthm_tiny.yaml"), search_paths=[os.path.join(REPO, "configs")])
    module = LTHMEncoder(cfg.model, torch.Generator().manual_seed(0))
    return {k: v.numpy() for k, v in state_dict_from_jax(jax_state, module).items()}


def test_rank0_logs_and_checkpoints_each_rank_snapshots(runs):
    names = sorted(os.listdir(runs["ckpt"]))
    assert "step_00000002.pt" in names
    assert {"data_iter_h0_s2.pkl", "data_iter_h1_s2.pkl"} <= set(names)
    lines = _jsonl(os.path.join(runs["out"], "spans.jsonl"))
    val = [r for r in lines if r["event"] == "metrics" and "val_loss" in r["metrics"]]
    assert len(val) == 1 and np.isfinite(val[0]["metrics"]["val_loss"])


def test_resume_of_a_row_sharded_table_ends_on_the_uninterrupted_bits(runs):
    """model = 2 with the table's rows split and trained: the step-2
    checkpoint holds the whole table and its rowwise moments (rank 0 wrote
    it), and the resumed run ends on the uninterrupted run's bits, whose
    table moved."""
    payload = torch.load(os.path.join(runs["ckpt"] + "_sharded", "step_00000002.pt"), weights_only=False)
    table = payload["state"]["module"]["product_emb_module.embedding"]
    assert tuple(table.shape) == (100000, 16)  # lthm_tiny's whole table
    for r in runs["ranks"]:
        a, b = r["sharded"], r["sharded_resumed"]
        assert b["metrics"]["train_steps_total"] == STEPS
        for k, v in a["params"].items():
            np.testing.assert_array_equal(b["params"][k], v, err_msg=k)
    moved = runs["ranks"][0]["sharded"]["params"]["product_emb_module.embedding"] != table.numpy()
    assert moved.any()


def test_ranks_stop_together_when_one_nodes_shard_runs_out(runs):
    """One rank a node: node 0 reads two of the day's three files, node 1
    one; both stop at node 1's last full batch."""
    totals = [r["two_nodes"]["metrics"]["train_steps_total"] for r in runs["ranks"]]
    assert totals[0] == totals[1] == 64 // 32  # node 1's 64 users in batches of 32


def test_weak_scaling_tool_runs_ranks_and_names_its_regime():
    """``tools/weak_scaling.py`` over 1 and 2 gloo ranks at a fixed batch a
    rank: one line a count and the efficiency series, named as the host's
    cores, not a network."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "recommendations_tpu_torch.tools.weak_scaling", "--device", "cpu", "--ranks", "1",
         "2", "--steps", "1", "--per-rank-batch", "2", "--seq", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    assert [x["ranks"] for x in lines[:2]] == [1, 2] and lines[1]["global_batch"] == 4
    assert all(x["regime"] == "gloo_on_host_cores" for x in lines[:2])
    assert lines[2]["metric"] == "weak_scaling_efficiency" and set(lines[2]["series"]) == {"1", "2"}
    assert "not a network" in lines[2]["note"]
