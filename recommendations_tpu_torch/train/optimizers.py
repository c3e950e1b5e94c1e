"""Optimizer assembly: the model's parameter groups -> ``torch.optim.AdamW``,
with gradient clipping in front.

Port of ``recommendations_tpu/train/optimizers.py`` ``build_optimizer``. The
LTHM main group is ``optax.adamw(lr, b1, b2, weight_decay)``, which
``torch.optim.AdamW`` computes in exact arithmetic (eps 1e-8 in both; the
weight decay is passed explicitly, torch's default being 0.01). A group the
model marks None does not train. Parameters no group claims fall into the
trainer config's default group: Adam, or AdamW when ``weight_decay`` is set.
Clipping composes as in the optax chain: by global norm, then by value.
Gradient accumulation (``optax.MultiSteps``) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm``, in place: every gradient scaled by
    max_norm / ||g|| when the global norm ||g|| is at least max_norm."""
    if not grads:
        return
    g_norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / g_norm.to(g.dtype) * max_norm))


def clip_by_value(grads: List[torch.Tensor], max_abs: float) -> None:
    """``optax.clip``, in place."""
    for g in grads:
        g.clamp_(-max_abs, max_abs)


class TrainOptimizer:
    """AdamW over the trainable groups, with the trainer config's clipping
    applied to the gradients first."""

    def __init__(
        self,
        inner: torch.optim.Optimizer,
        clip_norm: Optional[float] = None,
        clip_value: Optional[float] = None,
    ):
        self.inner = inner
        self.clip_norm, self.clip_value = clip_norm, clip_value

    def params(self) -> Iterable[torch.nn.Parameter]:
        for group in self.inner.param_groups:
            yield from group["params"]

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params() if p.grad is not None]
        if self.clip_norm:
            clip_by_global_norm(grads, self.clip_norm)
        if self.clip_value:
            clip_by_value(grads, self.clip_value)
        self.inner.step()


def build_optimizer(wrapper, train_config: ModelTrainConfig) -> TrainOptimizer:
    tc = train_config
    if tc.gradient_accumulation_steps and tc.gradient_accumulation_steps > 1:
        raise NotImplementedError(
            "gradient_accumulation_steps > 1 (optax.MultiSteps): ROADMAP, port queue item 4"
        )
    groups = wrapper.optimizers_for_param_groups() or {}
    labels = wrapper.param_labels()
    default = dict(lr=tc.learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=tc.weight_decay or 0.0)
    by_group = {}
    for name, p in wrapper.module.named_parameters():
        label = labels[name]
        settings = groups[label] if label in groups else default
        if settings is None or not p.requires_grad:
            continue
        key = label if label in groups else "__default__"
        by_group.setdefault(key, (settings, []))[1].append(p)
    param_groups = [dict(params=ps, **settings) for settings, ps in by_group.values()]
    inner = torch.optim.AdamW(param_groups)
    return TrainOptimizer(inner, tc.gradient_clip_norm, tc.gradient_clip_value)
