"""Optimizer assembly: the model's parameter groups -> ``torch.optim.AdamW``
and, for the product-embedding table, ``RowwiseAdam``, with gradient
clipping in front.

Port of ``recommendations_tpu/train/optimizers.py`` (``build_optimizer``,
``rowwise_adam``). The LTHM main group is ``optax.adamw(lr, b1, b2,
weight_decay)``, which ``torch.optim.AdamW`` computes in exact arithmetic
(eps 1e-8 in both; the weight decay is passed explicitly, torch's default
being 0.01). A group whose settings carry ``optimizer="rowwise_adam"`` runs
``RowwiseAdam``. A group the model marks None is not stepped by the
optimizer (a frozen table, or one the training step updates itself).
Parameters no group claims fall into the trainer config's default group:
Adam, or AdamW when ``weight_decay`` is set.

Clipping composes as in the optax chain, by global norm and then by value,
over the gradient of every parameter that has one, as optax clips the whole
gradient tree before ``multi_transform``: a table the step updates outside
the optimizer still counts in the norm that scales the others. Gradient
accumulation (``optax.MultiSteps``) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
from recommendations_tpu_torch.train.sparse_table import bias_corrections


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


class RowwiseAdam(torch.optim.Optimizer):
    """Adam with the second moment averaged per row (``rowwise_adam``): for
    an (N, d) table the state is ``exp_avg`` (N, d) and ``exp_avg_sq``
    (N, 1); no weight decay; one global count, as the optax transform keeps
    one ``count`` for its whole tree."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, eps = group["lr"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.int32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros((*p.shape[:-1], 1), dtype=p.dtype, device=p.device)
                g = p.grad
                st["step"] += 1
                mu = st["exp_avg"].mul_(b1).add_((1 - b1) * g)
                nu = st["exp_avg_sq"].mul_(b2).add_((1 - b2) * g.square().mean(dim=-1, keepdim=True))
                c1, c2 = bias_corrections(st["step"], b1, b2)
                p.add_(-lr * (mu * (1.0 / c1)) / ((nu * (1.0 / c2)).sqrt() + eps))


class TrainOptimizer:
    """AdamW over the main groups and ``RowwiseAdam`` over a rowwise group,
    with the trainer config's clipping applied first to the gradients of
    ``clip_params`` (every parameter of the model)."""

    def __init__(
        self,
        inner: torch.optim.Optimizer,
        clip_norm: Optional[float],
        clip_value: Optional[float],
        table: Optional[torch.optim.Optimizer],
        clip_params: List[torch.nn.Parameter],
    ):
        self.inner, self.table = inner, table
        self.clip_norm, self.clip_value = clip_norm, clip_value
        self.clip_params = clip_params

    def optimizers(self) -> List[torch.optim.Optimizer]:
        return [self.inner] + ([self.table] if self.table is not None else [])

    def params(self) -> Iterable[torch.nn.Parameter]:
        for opt in self.optimizers():
            for group in opt.param_groups:
                yield from group["params"]

    def zero_grad(self) -> None:
        for p in self.clip_params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.clip_params if p.grad is not None]
        if self.clip_norm:
            clip_by_global_norm(grads, self.clip_norm)
        if self.clip_value:
            clip_by_value(grads, self.clip_value)
        for opt in self.optimizers():
            opt.step()


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
    adamw, rowwise = [], []
    for settings, ps in by_group.values():
        settings = dict(settings)
        kind = settings.pop("optimizer", "adamw")
        (rowwise if kind == "rowwise_adam" else adamw).append(dict(params=ps, **settings))
    inner = torch.optim.AdamW(adamw)
    table = RowwiseAdam(rowwise, lr=rowwise[0]["lr"]) if rowwise else None
    return TrainOptimizer(inner, tc.gradient_clip_norm, tc.gradient_clip_value, table,
                          list(wrapper.module.parameters()))
