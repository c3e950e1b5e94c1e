"""The port's numerics debug mode (recommendations_tpu_torch/core/debug.py,
``training_strategy.debug_numerics``), mirroring tests/test_debug_mode.py:
a clean step passes through unchanged; the first NaN or Inf an operation
produces raises with the operation's name, in the forward and in the
backward; a hand-written kernel's outputs are checked by kernel name; the
LTHM's training step passes clean (its by-design NaN metrics and -inf CE
rows included) and raises at a planted NaN; the strategy falls back from
steps_per_dispatch to 1 with the JAX package's warning."""

import logging

import pytest
import torch

from recommendations_tpu_torch.core import debug
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState
from test_torch_train import small_batch, small_config


def test_clean_step_passes_through():
    f = debug.checked_step(lambda x: (x * 2.0).sum())
    assert float(f(torch.ones(4))) == 8.0


def test_nan_raises_with_the_operation():
    f = debug.checked_step(lambda x: torch.log(x).sum())
    with pytest.raises(FloatingPointError, match="NaN produced by operation aten.log"):
        f(torch.tensor([1.0, -1.0, 2.0]))


def test_overflow_raises_but_log_of_zero_does_not():
    with pytest.raises(FloatingPointError, match="Inf produced by operation aten.exp"):
        debug.checked_step(lambda x: torch.exp(x).sum())(torch.tensor([1.0, 1000.0]))
    # log(0) = -inf: the CE's value for a fully masked row, by design
    assert float(debug.checked_step(lambda x: torch.log(x).min())(torch.tensor([0.0, 2.0]))) == float("-inf")
    # an Inf an input already held is passed on, not produced
    assert float(debug.checked_step(lambda x: (x + 1).max())(torch.tensor([float("inf"), 0.0]))) == float("inf")


def test_backward_nan_raises_with_the_operation():
    x = torch.tensor([0.0, 4.0], requires_grad=True)

    def step(x):
        y = torch.sqrt(x).sum()
        y.backward()  # d sqrt(x) / dx at 0 is inf
        return y

    with pytest.raises(FloatingPointError, match="produced by operation aten"):
        debug.checked_step(step)(x)


def test_kernel_outputs_are_checked_by_kernel_name():
    bad = torch.tensor([1.0, float("nan")])
    debug.check_kernel_outputs("flash_bias_fwd", [bad])  # outside the mode: no check
    with debug.numerics_checked():
        with pytest.raises(FloatingPointError, match="NaN produced by kernel flash_bias_fwd"):
            debug.check_kernel_outputs("flash_bias_fwd", [torch.ones(2), bad])
        debug.check_kernel_outputs("ce_fwd", [torch.tensor([float("-inf"), 0.0])], allow_neg_inf=True)
        with pytest.raises(FloatingPointError, match="Inf produced by kernel ce_dq"):
            debug.check_kernel_outputs("ce_dq", [torch.tensor([float("-inf")])])
    assert not debug.numerics_checking()


def test_unchecked_region_allows_nans_by_design():
    def step(x):
        with debug.unchecked():
            m = torch.nanquantile(torch.where(x > 5, x, float("nan")), 0.5)
        return (x * 2).sum(), m

    total, median = debug.checked_step(step)(torch.arange(4.0))
    assert float(total) == 12.0 and torch.isnan(median)


@pytest.mark.parametrize("use_flash,beta,mini_batch", [(True, 0.0, -1), (False, 0.5, 3)])
def test_lthm_step_is_unchanged_and_a_planted_nan_raises(use_flash, beta, mini_batch):
    """A checked training step (dropout on) gives the unchecked step's loss
    bit for bit; a NaN planted in one weight raises at the first operation
    that reads it."""
    d = small_config(use_flash, "float32", beta, mini_batch)
    d["transformer_config"]["attn_config"].update(dropout=0.1, attn_dropout=0.1)
    losses = []
    for checked in (False, True):
        tw = LTHMModelWrapper(LTHMModelConfig.from_dict(d), device="cpu", seed=2)
        state = TrainState.create(tw)
        step = debug.checked_step(train_step) if checked else train_step
        losses.append(float(step(state, small_batch(), offsets=[0, 1, 3])[0]))
    assert losses[0] == losses[1]
    with torch.no_grad():
        tw.module.query_tower.transformer.block_1.c_fc.weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="NaN produced by operation aten.(addmm|mm)"):
        debug.checked_step(train_step)(state, small_batch(), offsets=[0, 1, 3])


def test_debug_numerics_turns_steps_per_dispatch_off_with_jax_warning(tmp_path, caplog):
    from recommendations_tpu_torch import main_training
    from recommendations_tpu_torch.data.data_store import FakeDataStore
    from recommendations_tpu_torch.tools.synth_data import write_synthetic_dataset

    FakeDataStore.reset()
    write_synthetic_dataset(None, ["20240101", "20240102"], 2, 48, 64, fake_store=True)
    argv = ["--config-name", "lthm_tiny", "--device", "cpu", "dataset.filesystem_config.kind=fake",
            f"export.filesystem_config.local_dir_prefix={tmp_path}", "train.train_steps=2",
            "train.train_metrics_every_n_steps=1", "train.val_metrics_every_n_steps=2",
            f"trackers.trackers=[{{kind: jsonl, path: {tmp_path}/m.jsonl}}]",
            "training_strategy.debug_numerics=true", "train.steps_per_dispatch=2"]
    with caplog.at_level(logging.WARNING):
        _, metrics = main_training.main(argv, return_pipeline=True)
    assert metrics["train_steps_total"] == 2
    assert "steps_per_dispatch=2 requested but multi-step program unavailable (debug_numerics?); using 1" in \
        caplog.text
