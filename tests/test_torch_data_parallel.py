"""Data-parallel training in the port: ``main_training`` on lthm_tiny.yaml
over 2 gloo worker processes (one node, 16 of its 32 rows a rank) against
the JAX package's train step (op by op) on a 2-device CPU mesh
(``jax.devices()[:2]``, the batch split over ``data``, each operation run
partitioned) on the same global batch, from the same initial weights and
lookahead offsets, with the loss chunk spanning both ranks
(``train_mini_batch_size`` -1): the first step's loss (1e-4) and its
gradients summed over the ranks (2e-4), and the losses of the next steps
(1e-4) and the parameters after three (2e-4). With chunks of 16 within
each rank, one step is held to the port's one-process step (chunked,
JAX's scan is compiled on the CPU, so ``tests/test_torch_loss.py`` holds
the chunked loss to JAX op by op).

The LSH direction tables take their gradients from bf16 one-hot products
(JAX ``nn/lsh.py``, bf16 even at a float32 compute dtype). JAX's 2-device
step rounds each device's partial product to bf16, sums the partials and
rounds the sum to bf16 again; so do the port's ranks
(``train.step.reduce_gradients``), where one process rounds the whole sum
once. The test runs that step: op by op and compiled, its gradients are
bf16 values, and the compiled program converts each device's partial to
bf16 before its all-reduce. Against it the port's 2 ranks hold those
gradients to one bf16 rounding (TWO_DEVICE_BF16_GRAD_RTOL, 2**-8), as bf16
values of which at least SAME_BITS are JAX's bits, and every loss to 1e-4. JAX's own
2-device step differs from its one-device step by two bf16 roundings
there (BF16_GRAD_RTOL, 2**-7), and its later losses by up to 5e-4: the
limits of parity of the port's ranks against one process (ROADMAP section
3), held by the test of chunks within the ranks. Adam's first update moves
each element by lr * g / (|g| + eps), so an element whose gradient cancels
to rounding noise moves by up to lr either way: one rank's bf16 partial
rounded to the other side of an edge is enough (in JAX's 2-device step
too). Such elements (|g| below NOISE in the reference's first gradient)
are left out of the parameter comparison; against one process, where one
of them flips, the next losses move by up to LR_FLIP_LOSS, and the run
says how many flipped.

Then the strategy's
cooperative parts: rank 0 alone logs and checkpoints while each rank
writes its iterator snapshot; with the table's rows split over model = 2
and trained, rank 0's step-2 checkpoint holds the whole table and a resume
from it ends on the uninterrupted run's bits; with one rank a node (each
reading its own files) the ranks stop together when the shorter shard
runs out."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

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
TWO_DEVICE_BF16_GRAD_RTOL = 2.0 ** -8  # one bf16 rounding: 2 ranks against JAX's 2 devices
BF16_GRAD_RTOL = 2.0 ** -7  # two bf16 roundings: 2 ranks (or JAX's 2 devices) against one process
SAME_BITS = 0.95  # the share of those gradients' elements that are JAX's 2-device bits (measured 0.984)
NOISE = 1e-5  # a first gradient this small: Adam's first step is rounding's sign
LR_FLIP_LOSS = 1e-3  # lthm_tiny's lr: what one flipped element can move a loss by (against one process)


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


def _jax_steps(cfg, variables, strategy, steps, mesh=None):
    """JAX's train step, op by op, on the global batches: losses, the first
    step's gradients and the parameters after the steps. With chunks of
    the batch its loss scans them, which compiles: then ``jax.disable_jit``
    (compiled on the CPU, XLA drops the bf16 logits storage, ROADMAP
    section 3). With ``mesh`` (a JAX mesh of one ``data`` axis) the
    state is replicated and each batch split over ``data``: each operation
    then runs partitioned over the devices, as in JAX's own multi-device
    step."""
    if cfg.model.train_mini_batch_size > 0:
        with jax.disable_jit():
            return _jax_steps_op_by_op(cfg, variables, strategy, steps, mesh)
    return _jax_steps_op_by_op(cfg, variables, strategy, steps, mesh)


def _placement(mesh):
    """(replicate a tree, split an array's rows over ``data``) on ``mesh``;
    identities without one."""
    if mesh is None:
        return (lambda tree: tree), (lambda x: x)
    return (lambda tree: jax.device_put(tree, NamedSharding(mesh, PartitionSpec())),
            lambda x: jax.device_put(x, NamedSharding(mesh, PartitionSpec("data", *([None] * (x.ndim - 1))))))


def _jax_steps_op_by_op(cfg, variables, strategy, steps, mesh=None):
    replicate, split = _placement(mesh)
    jw = JaxWrapper(cfg.model)
    params, constants = replicate(variables["params"]), replicate(variables.get("constants", {}))
    optimizer = jax_build_optimizer(jw, cfg.train, params)
    state = JaxTrainState.create(params, constants, optimizer.init(params), replicate(jw.init_aux_state()),
                                 replicate(jax.random.split(jax.random.PRNGKey(0))[1]))
    losses = []
    for batch in jax_loader("train", 0, jax_train_paths(cfg.dataset), cfg.train.batch_size, steps, strategy,
                            cfg.model.features, cfg.dataset.filesystem_config):
        b = {k: split(jnp.asarray(v)) for k, v in batch.items() if v.dtype != object}
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


def _jax_first_grads_compiled(cfg, variables, strategy, mesh):
    """JAX's first gradient compiled over ``mesh`` (the batch split over
    ``data``), and the compiled program's text."""
    replicate, split = _placement(mesh)
    jw = JaxWrapper(cfg.model)
    batch = next(iter(jax_loader("train", 0, jax_train_paths(cfg.dataset), cfg.train.batch_size, 1, strategy,
                                 cfg.model.features, cfg.dataset.filesystem_config)))
    b = {k: split(jnp.asarray(v)) for k, v in batch.items() if v.dtype != object}
    sub = jax.random.split(jax.random.split(jax.random.PRNGKey(0))[1])[1]

    def grads(params, constants, aux, b):
        return jax.grad(lambda p: jw.loss_and_metrics(p, constants, aux, b, sub, True)[0])(params)

    args = (*replicate((variables["params"], variables.get("constants", {}), jw.init_aux_state())), b)
    compiled = jax.jit(grads).lower(*args).compile()
    out = jax.tree_util.tree_map(np.asarray, compiled(*args))
    zeros = jax.tree_util.tree_map(lambda c: np.zeros_like(np.asarray(c)), variables.get("constants", {}))
    return {"params": out, "constants": zeros}, compiled.as_text()


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
    two_devices = Mesh(np.array(jax.devices()[:2]), ("data",))
    spans = _jax_steps(spans_cfg, variables, strategy, STEPS, two_devices)
    spans_one_device = _jax_steps(spans_cfg, variables, strategy, STEPS)
    compiled = _jax_first_grads_compiled(spans_cfg, variables, strategy, two_devices)
    one = torch_dist_worker.CASES["train"](args=["--config-name", "lthm_tiny", *_args(
        root, out, "within_one", 1, ["model.train_mini_batch_size=16"])], variables=np_vars, offsets=offsets)
    ranks = workers.results()
    return {"ranks": ranks, "out": out, "ckpt": ckpt, "one": one, "uneven": uneven,
            "jax": {"spans": spans, "spans_one_device": spans_one_device, "compiled": compiled}}


def _held_to(runs, run, losses, first, want, bf16_rtol=BF16_GRAD_RTOL, flip_loss=LR_FLIP_LOSS):
    """``run``'s first summed gradients, parameters (both ranks' bits equal)
    and jsonl losses held to a reference's (see the module docstring)."""
    r0, r1 = (r[run] for r in runs["ranks"])
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k], err_msg=k)
    for k, g in r0["first_grads"].items():
        if g is not None:
            rtol = bf16_rtol if k.startswith(BF16_GRAD) else GRAD_TOL
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
    np.testing.assert_allclose(logged[1:], losses[1:], rtol=0, atol=flip_loss if flipped else LOSS_TOL,
                               err_msg=f"{flipped} noise-level elements took the other Adam step")


def test_chunk_spanning_the_ranks_matches_jax(runs):
    """lthm_tiny's whole-batch chunk over 2 ranks: the losses of 3 steps of
    JAX's step on 2 devices, its first gradients (the LSH tables' to one
    bf16 rounding) and its parameters after them; the later losses at
    1e-4, also where a noise-level element took the other Adam step."""
    import ml_dtypes

    losses, jax_first, jax_state = runs["jax"]["spans"]
    first = _by_port_key(jax_first)
    _held_to(runs, "spans", losses, first, _by_port_key(jax_state),
             bf16_rtol=TWO_DEVICE_BF16_GRAD_RTOL, flip_loss=LOSS_TOL)
    # the LSH tables' summed gradients are bf16 values, as JAX's, and mostly its bits
    for k, g in runs["ranks"][0]["spans"]["first_grads"].items():
        if k.startswith(BF16_GRAD) and g is not None:
            np.testing.assert_array_equal(g.astype(ml_dtypes.bfloat16).astype(np.float32), g, err_msg=k)
            assert np.mean(g == first[k]) >= SAME_BITS, k


def test_jax_two_device_step_rounds_the_lsh_gradients_as_the_ranks(runs):
    """JAX's own step on 2 devices against its one-device step: the LSH
    tables' first gradients are bf16 values on both, and apart (each
    device's partial rounded) by up to two bf16 roundings; every other
    gradient at 2e-4 and the later losses within LR_FLIP_LOSS. Compiled,
    the 2-device program keeps the roundings: its LSH gradients are bf16
    values, and the gradient product's output is converted to bf16 before
    the all-reduce."""
    import ml_dtypes

    losses2, first2, _ = runs["jax"]["spans"]
    losses1, first1, _ = runs["jax"]["spans_one_device"]
    g2, g1 = _by_port_key(first2), _by_port_key(first1)
    compiled, hlo = runs["jax"]["compiled"]
    compiled = _by_port_key(compiled)
    lsh = [k for k in g2 if k.startswith(BF16_GRAD) and k.endswith("embedding")]
    assert len(lsh) == 2
    for k in lsh:
        for g in (g2[k], g1[k], compiled[k]):
            np.testing.assert_array_equal(g.astype(ml_dtypes.bfloat16).astype(np.float32), g, err_msg=k)
        assert (g2[k] != g1[k]).any(), k
        np.testing.assert_allclose(g2[k], g1[k], rtol=BF16_GRAD_RTOL, atol=GRAD_TOL, err_msg=k)
    for k in g2:
        if k not in lsh:
            np.testing.assert_allclose(g2[k], g1[k], rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)
    assert abs(losses2[0] - losses1[0]) <= LOSS_TOL
    np.testing.assert_allclose(losses2[1:], losses1[1:], rtol=0, atol=LR_FLIP_LOSS)
    for i in range(2):
        # the partial product of the table's gradient, rounded to bf16 on each device
        assert re.search(rf"convert\.\d+ = bf16\[[0-9,]+\]\S* convert\([^)]*\), metadata=\{{op_name=\"[^\"]*"
                         rf"transpose\(jvp\(LTHMEncoder\)\)/product_tower/direction_emb_{i}/[^\"]*dot_general", hlo), i
    assert "all-reduce(" in hlo


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


def test_weak_scaling_measures_on_the_card_unless_told_the_cpu(monkeypatch, capsys):
    """``measure`` runs on the card by default and raises without one; the
    CLI names the rank counts it drops for want of cards."""
    from recommendations_tpu_torch.tools import weak_scaling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weak_scaling.measure(1, 2, 8, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(weak_scaling, "measure", lambda n, *a: pytest.fail("no count fits one card but 1"))
    assert weak_scaling.main(["--ranks", "2", "4"]) == 0
    err = capsys.readouterr().err
    assert "skipping rank counts [2, 4]" in err and "1 card(s)" in err
