"""The ranker over a mesh of ranks in the port, against the JAX package's
ranker step on the global batch, on the CPU (2 gloo worker processes,
``tests/torch_dist.py``).

JAX replicates the ranker's parameters (``REPLICATED``) and computes each
task's loss, accuracy and positive rate as means over the valid rows of the
whole batch, and the AUC over the whole batch's logits, pad rows ranked
too. The port's ranks hold the same means through the valid count summed
over ``data`` and the logits gathered for the AUC
(``models/ranker/wrapper.py``), and the step sums the gradients over
``data`` (``models/base.py``'s mesh hooks).

- ``train_step`` of a config with every feature kind on 2 ranks, two
  global batches of 40 rows with 7 and 23 pad rows (the second leaves
  rank 1 with pad rows only): each step's loss and every metric at 1e-5
  (``tests/test_torch_ranker.py``'s), the gradient norm at 2e-4 relative,
  the validation metrics after the steps at 1e-5, and the parameters after
  the two steps at 2e-4 norm-relative against JAX's jitted step with
  optax's AdamW; both ranks' parameters are the same bits.
- ``main_training`` on ``ranker_train.yaml`` (its own widths, parquet
  written by JAX's synth) over 2 ranks, 4 steps of 256 and a validation of
  2 batches, against JAX's step and validation on the same global batches:
  rank 0's logged losses and metrics at 1e-5 (the AUC, a rank statistic,
  at 1e-5 too), the parameters after the run at 2e-4 norm-relative.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommendations_tpu.config.trainer_config import ModelTrainConfig as JaxTrainConfig
from recommendations_tpu.config.yaml_loader import load_config as jax_load_config
from recommendations_tpu.config.yaml_loader import parse_cli_overrides as jax_parse
from recommendations_tpu.data.generator import get_data_loader_strategy as jax_strategy
from recommendations_tpu.data.loader import get_host_dataloader as jax_loader
from recommendations_tpu.data.paths import get_train_data_paths as jax_train_paths
from recommendations_tpu.data.paths import get_val_data_paths as jax_val_paths
from recommendations_tpu.models.ranker.config import RankerModelConfig as JaxConfig
from recommendations_tpu.models.ranker.wrapper import RankerModelWrapper as JaxWrapper
from recommendations_tpu.tools import synth_data as jsynth
from recommendations_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from recommendations_tpu_torch.config.yaml_loader import load_config
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.models.ranker.config import RankerModelConfig
from recommendations_tpu_torch.models.ranker.model import FactorizedDLRM
from test_torch_ranker import kinds_batch, kinds_config
from torch_dist import start_workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
STEPS = 4
TOL = 1e-5       # the loss and the metrics, float32 (tests/test_torch_ranker.py)
GRAD_TOL = 2e-4  # gradients and the parameters after a step, norm-relative


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def _port_params(config, params):
    """JAX's parameters under the port's state-dict keys."""
    module = FactorizedDLRM(config, torch.Generator().manual_seed(0))
    return {k: v.numpy() for k, v in state_dict_from_jax({"params": _np(params)}, module).items()}


def _jax_steps(jw, params, opt, batches):
    """JAX's jitted ranker step on each global batch: (each step's metrics
    with the loss and the gradient norm, the parameters after the steps)."""

    @jax.jit
    def step(params, opt_state, batch):
        def loss_fn(p):
            return jw.loss_and_metrics(p, {}, None, batch, jax.random.PRNGKey(0), True)

        (loss, (metrics, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, metrics, optax.global_norm(grads)

    opt_state, out = opt.init(params), []
    for b in batches:
        params, opt_state, loss, metrics, gnorm = step(params, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append(dict({k: float(v) for k, v in metrics.items()}, loss=float(loss), grad_norm=float(gnorm)))
    return out, params


def _val(jw, params, batch):
    _, (metrics, _) = jax.jit(lambda p, b: jw.loss_and_metrics(p, {}, None, b, jax.random.PRNGKey(0), False))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}


def _close_metrics(got, want, where):
    assert set(got) >= set(want), where
    for k, v in want.items():
        rtol = GRAD_TOL if k == "grad_norm" else 0.0
        assert abs(got[k] - v) <= TOL + rtol * abs(v), (where, k, got[k], v)


def _ranker_args(root, out, tag):
    return ["--config-name", "ranker_train", f"dataset.filesystem_config.local_dir_prefix={root}",
            f"export.filesystem_config.local_dir_prefix={out}/export",
            f"trackers.trackers=[{{kind: jsonl, path: {out}/{tag}.jsonl}}]", f"model_version={tag}", "run_id=r1",
            f"train.train_steps={STEPS}", "train.train_metrics_every_n_steps=1", "train.validation_steps=2",
            f"train.val_metrics_every_n_steps={STEPS}", "inference.skip_inference=true"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # train_step on every feature kind, with pad rows split unevenly
    d = kinds_config()
    jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
    variables = _np(jw.init_variables(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in kinds_batch().items()}))
    batches = [kinds_batch(n=40, seed=3, pad=7), kinds_batch(n=40, seed=5, pad=23)]
    # ranker_train.yaml through main_training, from parquet
    root = str(tmp_path_factory.mktemp("ranker_data"))
    out = str(tmp_path_factory.mktemp("ranker_out"))
    jsynth.write_ranking_dataset(root, ["20240101", "20240102"], files_per_date=2, rows_per_file=1024)
    cfg = jax_load_config(os.path.join(REPO, "configs", "ranker_train.yaml"),
                          overrides=jax_parse(_ranker_args(root, out, "jax")[2:]),
                          search_paths=[os.path.join(REPO, "configs")])
    strategy = jax_strategy(cfg.data_loader, cfg.model.features.get_input_columns(), cfg.model.preprocess_fn)

    def loader(kind, paths, steps):
        for b in jax_loader(kind, 0, paths, cfg.train.batch_size, steps, strategy, cfg.model.features,
                            cfg.dataset.filesystem_config):
            yield {k: v for k, v in b.items() if v.dtype != object}

    train = list(loader("train", jax_train_paths(cfg.dataset), STEPS))
    val = list(loader("val", jax_val_paths(cfg.dataset), 2))
    yw = JaxWrapper(cfg.model)
    yvars = _np(yw.init_variables(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in train[0].items()}))

    workers = start_workers([
        ("steps", "ranker_steps", dict(config=d, variables=variables, batches=batches)),
        ("yaml", "train", dict(args=_ranker_args(root, out, "port"), variables=yvars)),
    ], WORLD, timeout=180)
    jax_steps = _jax_steps(jw, variables["params"], jax_build_optimizer(jw, JaxTrainConfig(), variables["params"]),
                           batches)
    jax_val = _val(jw, jax_steps[1], batches[-1])
    yaml_steps, yaml_params = _jax_steps(yw, yvars["params"], jax_build_optimizer(yw, cfg.train, yvars["params"]),
                                         train)
    yaml_val = [_val(yw, yaml_params, b) for b in val]
    ranks = workers.results()
    return {"ranks": ranks, "out": out, "config": d,
            "jax": {"steps": jax_steps, "val": jax_val, "yaml": (yaml_steps, yaml_params, yaml_val)}}


def test_train_step_over_two_ranks_matches_jax_on_the_global_batch(runs):
    """Pad rows split unevenly (7 of 40 on rank 1; then 3 on rank 0 and all
    20 of rank 1's): both steps' loss and metrics, the validation metrics
    and the parameters after two steps."""
    want_steps, want_params = runs["jax"]["steps"]
    r0, r1 = (r["steps"] for r in runs["ranks"])
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k], err_msg=k)
    assert r0["steps"] == r1["steps"] and r0["val"] == r1["val"]
    for i, (got, want) in enumerate(zip(r0["steps"], want_steps)):
        _close_metrics(got, want, f"step {i}")
        assert got["params_nan"] == 0.0
    _close_metrics(r0["val"], runs["jax"]["val"], "val")
    want = _port_params(RankerModelConfig.from_dict(runs["config"]), want_params)
    assert set(want) == set(r0["params"])
    for k, v in want.items():
        assert _rel(r0["params"][k], v) <= GRAD_TOL, k


def test_main_training_over_two_ranks_matches_jax(runs):
    """``ranker_train.yaml`` on 2 ranks: rank 0 alone logs, each step's
    metrics and the validation's are JAX's on the global batch, and both
    ranks end on JAX's parameters."""
    steps, params, val = runs["jax"]["yaml"]
    with open(os.path.join(runs["out"], "port.jsonl")) as f:
        lines = [r["metrics"] for r in map(json.loads, f) if r["event"] == "metrics"]
    train = [m for m in lines if "train_loss" in m]
    vals = [m for m in lines if "val_loss" in m]
    assert [m["steps"] for m in train] == list(range(1, STEPS + 1)) and len(vals) == 1
    for i, (got, want) in enumerate(zip(train, steps)):
        want = {k: v for k, v in want.items() if k != "loss"}  # logged as train_loss
        _close_metrics(got, want, f"step {i + 1}")
    want_val = {k: float(np.mean([v[k] for v in val])) for k in val[0]}
    _close_metrics(vals[0], want_val, "val")
    cfg = load_config(os.path.join(REPO, "configs", "ranker_train.yaml"), search_paths=[os.path.join(REPO, "configs")])
    want = _port_params(cfg.model, params)
    for r in runs["ranks"]:
        got = r["yaml"]
        assert got["metrics"]["train_steps_total"] == STEPS
        for k, v in want.items():
            assert _rel(got["params"][k], v) <= GRAD_TOL, k
