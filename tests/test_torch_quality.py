"""Learning parity over a cut run, on the CPU: the port's trainer against
the JAX package's, through each package's ``main_training`` pipeline, on the
same synthetic data, the port starting from the initial variables JAX's
strategy drew.

- ``configs/lthm_tiny.yaml`` for LTHM_STEPS steps (cut from QUALITY.md's
  600) of LTHM_BATCH users (cut from 32, to keep the file near a minute) on
  ``tools/synth_data``'s click log (2 files x 800 users a date, history
  64: the files of QUALITY.md's config 1 and of ``chip_smoke.py``'s phase
  [7] at seed 0), the port taking JAX's lookahead offsets at every step and
  at every validation batch: every logged train loss, and the final
  validation's hit_rate@{1,5,20}, median hit position (lookahead 0) and loss.
- ``configs/ranker_train.yaml`` for RANKER_STEPS steps (cut from the 320 of
  ``chip_smoke.py``'s phase [7]) on ``write_ranking_dataset``'s impressions:
  every logged train loss, and the final validation's AUC on click and on
  conversion and its loss.

Both run at float32 compute: compiled, XLA drops some of the bf16 roundings
the port keeps (ROADMAP section 3), which would make the comparison one of
XLA's fusions. Each tolerance below is stated with its reason; a planted 1%
change of the softmax temperature (LTHM) or of the learning rate (ranker)
in the port fails these tests (CHANGES.md)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import main_training as jax_main_training
from recommendations_tpu.config.yaml_loader import load_config as jax_load_config
from recommendations_tpu.config.yaml_loader import parse_cli_overrides as jax_parse
from recommendations_tpu.models.lthm.loss import sample_offsets as jax_sample_offsets
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxLTHMWrapper
from recommendations_tpu.models.ranker.wrapper import RankerModelWrapper as JaxRankerWrapper
from recommendations_tpu.tools import synth_data as jsynth
from recommendations_tpu_torch import main_training
from recommendations_tpu_torch.models.lthm import loss as port_loss
from recommendations_tpu_torch.train.strategy import VAL_SEED

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
DATES = ["20240101", "20240102"]
LTHM_STEPS, LTHM_BATCH = 100, 16
RANKER_STEPS = 100

# The train loss (29.0 at step 1, 19.4 at step 100), absolute. Adam's first
# update moves each parameter by lr (1e-3) along its gradient's sign, and
# where a gradient is rounding noise the compiled JAX step and the port take
# opposite signs (ROADMAP section 3, limits of parity): such parameters land
# 2e-3 apart, and the step-2 loss moves by up to 2e-3 for it (measured
# 1.9e-3); later steps carry the gap, and it shrinks.
LTHM_LOSS_TOL = 5e-3
# The final validation, absolute, over the YAML's 4 batches of 16 users
# (2796 scored tokens). Measured against JAX: the loss 1.2e-5, hit@1 and
# hit@5 0, hit@20 3.5e-4 (one token), the median hit position 0.375 of 264.
# Under a planted 1% change of the softmax temperature: the loss 8.1e-4,
# hit@1 3.7e-4 (one token), hit@5 2.2e-3, hit@20 7.1e-4, the median 5.1.
# Each bound lies between the two: the loss 2e-4; hit@1 half a token,
# hit@5 2.5 tokens, hit@20 1.5 tokens (a logit that differs in the 5th
# digit moves a token across the k-th negative, and the rank metrics see the
# plant only through what the model learned: a few tokens); the median 1%.
LTHM_VAL_TOL = {"val_loss": 2e-4, "val_hit_rate_at_1_lookahead_0": 1.8e-4,
                "val_hit_rate_at_5_lookahead_0": 9e-4, "val_hit_rate_at_20_lookahead_0": 5.4e-4}
LTHM_MEDIAN_RTOL = 0.01
# The ranker's losses and AUCs: float32 products of one order on both sides
# (measured: 6.0e-7 on the train loss, 3.1e-7 on the val loss, the AUCs equal).
RANKER_LOSS_TOL = 1e-5
RANKER_VAL_TOL = {"val_auc_click": 1e-4, "val_auc_conversion": 1e-4, "val_loss": 1e-5}


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _train_losses(path):
    return [r["metrics"]["train_loss"] for r in _jsonl(path)
            if r["event"] == "metrics" and "train_loss" in r["metrics"]]


def _last_val(path):
    return [r["metrics"] for r in _jsonl(path) if r["event"] == "metrics" and "val_loss" in r["metrics"]][-1]


def _args(root, out, tag, steps):
    return [f"dataset.filesystem_config.local_dir_prefix={root}", f"export.filesystem_config.local_dir_prefix={out}",
            f"trackers.trackers=[{{kind: jsonl, path: {out}/{tag}.jsonl}}]", f"model_version={tag}", "run_id=r1",
            f"train.train_steps={steps}", f"train.val_metrics_every_n_steps={steps}",
            "train.train_metrics_every_n_steps=1"]


def _jax_run(config_name, wrapper_cls, args):
    """JAX's main_training pipeline; returns the initial variables its
    strategy drew (the wrapper's ``init_variables``, recorded for the run)."""
    recorded = []
    real = wrapper_cls.init_variables

    def init_variables(self, rng, batch):
        variables = real(self, rng, batch)
        recorded.append(jax.tree_util.tree_map(np.asarray, variables))
        return variables

    cfg = jax_load_config(os.path.join(CONFIGS, f"{config_name}.yaml"), overrides=jax_parse(args),
                          search_paths=[CONFIGS])
    wrapper_cls.init_variables = init_variables
    try:
        jax_main_training.execute_pipeline(cfg)
    finally:
        wrapper_cls.init_variables = real
    return cfg, recorded[0]


def _port_run(config_name, args, variables):
    """The port's main_training pipeline on the CPU from JAX's variables, on
    2 threads (the test files set 1 at import)."""
    cfg = main_training.load_config(os.path.join(CONFIGS, f"{config_name}.yaml"),
                                    overrides=main_training.parse_cli_overrides(args),
                                    search_paths=[str(main_training.CONFIG_ROOT)])
    pipeline = main_training.build_pipeline(cfg, "cpu")
    builder = pipeline.model_builder
    real_build = builder.build

    def build():
        wrapper = real_build()
        wrapper.load_jax_variables(variables)
        return wrapper

    builder.build = build
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return pipeline.execute()
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lthm_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lthm_tiny_data"))
    out = str(tmp_path_factory.mktemp("lthm_tiny_out"))
    jsynth.write_synthetic_dataset(root, DATES, files_per_date=2, users_per_file=800, history_len=64)
    extra = ["model.compute_dtype=float32", f"train.batch_size={LTHM_BATCH}"]
    cfg, variables = _jax_run("lthm_tiny", JaxLTHMWrapper, _args(root, out, "jax", LTHM_STEPS) + extra)
    # JAX's offsets: the strategy's rng is split(PRNGKey(0))[1], split once a
    # step, and the loss draws from split(step key)[1]; validation batch i
    # draws from split(fold_in(PRNGKey(1234), i))[1] (train/strategy.py)
    lookahead = list(cfg.model.lookahead)
    rng = jax.random.split(jax.random.PRNGKey(0))[1]
    pending = []
    for _ in range(LTHM_STEPS):
        rng, sub = jax.random.split(rng)
        pending.append(np.asarray(jax_sample_offsets(jax.random.split(sub)[1], lookahead)))

    def jax_offsets(generator, lookahead):
        batch = generator.initial_seed() - VAL_SEED  # validation batch i's generator is seeded VAL_SEED + i
        if batch < 0:
            return torch.from_numpy(pending.pop(0).copy())
        key = jax.random.fold_in(jax.random.PRNGKey(VAL_SEED), batch)
        return torch.from_numpy(np.asarray(jax_sample_offsets(jax.random.split(key)[1], lookahead)).copy())

    port_loss.sample_offsets, real = jax_offsets, port_loss.sample_offsets
    try:
        _port_run("lthm_tiny", _args(root, out, "port", LTHM_STEPS) + extra, variables)
    finally:
        port_loss.sample_offsets = real
    assert not pending
    return {"jax": f"{out}/jax.jsonl", "port": f"{out}/port.jsonl"}


@pytest.fixture(scope="module")
def ranker_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ranker_data"))
    out = str(tmp_path_factory.mktemp("ranker_out"))
    jsynth.write_ranking_dataset(root, DATES)
    _, variables = _jax_run("ranker_train", JaxRankerWrapper, _args(root, out, "jax", RANKER_STEPS))
    _port_run("ranker_train", _args(root, out, "port", RANKER_STEPS), variables)
    return {"jax": f"{out}/jax.jsonl", "port": f"{out}/port.jsonl"}


def test_lthm_tiny_train_loss_matches_jax_at_every_step(lthm_runs):
    want, got = _train_losses(lthm_runs["jax"]), _train_losses(lthm_runs["port"])
    assert len(got) == len(want) == LTHM_STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=LTHM_LOSS_TOL)
    assert np.mean(got[-10:]) < np.mean(got[:10]) - 0.5  # it learns


@pytest.mark.parametrize("metric", [*LTHM_VAL_TOL, "val_median_hit_position_lookahead_0"])
def test_lthm_tiny_final_validation_matches_jax(lthm_runs, metric):
    want, got = _last_val(lthm_runs["jax"])[metric], _last_val(lthm_runs["port"])[metric]
    if metric in LTHM_VAL_TOL:
        assert abs(got - want) <= LTHM_VAL_TOL[metric], (got, want)
    else:
        assert abs(got - want) <= LTHM_MEDIAN_RTOL * want, (got, want)


def test_ranker_train_loss_matches_jax_at_every_step(ranker_runs):
    want, got = _train_losses(ranker_runs["jax"]), _train_losses(ranker_runs["port"])
    assert len(got) == len(want) == RANKER_STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=RANKER_LOSS_TOL)
    assert np.mean(got[-10:]) < np.mean(got[:10])  # it learns


@pytest.mark.parametrize("metric", list(RANKER_VAL_TOL))
def test_ranker_final_validation_matches_jax(ranker_runs, metric):
    want, got = _last_val(ranker_runs["jax"])[metric], _last_val(ranker_runs["port"])[metric]
    assert abs(got - want) <= RANKER_VAL_TOL[metric], (got, want)
