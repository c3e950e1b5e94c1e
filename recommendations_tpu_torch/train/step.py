"""The single-GPU training step.

Port of the dense path of ``recommendations_tpu/train/strategy.py``'s
``train_step`` (as ``bench.py`` times it): forward, loss and backward; the
optimizer step; the new aux state; the metrics ``grad_norm`` (of the raw
gradients) and ``params_nan``; ``step += 1``. The sparse-tap and lazy-table
branches are not ported: their table optimizers raise when the state is
built (``wrapper.optimizers_for_param_groups``).

The phases run inside ``torch.profiler.record_function`` ranges named
``lthm/...`` (forward and loss in the wrapper, the CE backward in the loss),
which ``tools/profile_torch_training.py`` reads; outside a profiler a range
costs a few microseconds.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch
from torch.profiler import record_function

from recommendations_tpu_torch.models.lthm.loss import Metrics
from recommendations_tpu_torch.train.train_state import TrainState


def train_step(
    state: TrainState, batch: Mapping[str, Any], offsets=None
) -> Tuple[torch.Tensor, Metrics]:
    """One step in place on ``state``; returns (loss, metrics) as device
    tensors. ``offsets`` overrides the draw from ``state.generator``."""
    wrapper = state.wrapper
    state.optimizer.zero_grad()
    loss, metrics, new_aux = wrapper.loss_and_metrics(
        batch, state.aux, True, offsets=offsets, generator=state.generator
    )
    with record_function("lthm/backward"):
        loss.backward()
    params = list(wrapper.module.parameters())
    with record_function("lthm/optimizer"), torch.no_grad():
        gsq = torch.stack([p.grad.float().square().sum() for p in params if p.grad is not None])
        metrics["grad_norm"] = gsq.sum().sqrt()
        state.optimizer.step()
        nan = torch.stack([p.isnan().any() for p in params if p.is_floating_point()])
        metrics["params_nan"] = nan.any().float()
    state.aux = new_aux
    state.step += 1
    return loss.detach(), metrics
