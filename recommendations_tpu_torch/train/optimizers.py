"""Optimizer assembly: the model's parameter groups -> ``torch.optim``
optimizers, with gradient clipping in front and gradient accumulation
around them.

Port of ``recommendations_tpu/train/optimizers.py`` (``build_optimizer``,
``_default_tx``, ``rowwise_adam``). The LTHM main group is ``optax.adamw(lr,
b1, b2, weight_decay)``, which ``torch.optim.AdamW`` computes in exact
arithmetic (eps 1e-8 in both; the weight decay is passed explicitly, torch's
default being 0.01). A group whose settings carry
``optimizer="rowwise_adam"`` runs ``RowwiseAdam``. A group the model marks
None is not stepped by the optimizer (a frozen table, or one the training
step updates itself).

Parameters no group claims fall into the trainer config's default group
(``_default_tx``): the optax optimizer ``optimizer_clazz`` names, with
``optimizer_kwargs`` and the config's learning rate unless the kwargs give
one; otherwise Adam, or AdamW when ``weight_decay`` is set, at the
learning rate of the schedule ``lr_scheduler_clazz`` names (a
``LambdaLR`` over the group, stepped once per optimizer update, so the
update at optax's count n takes the schedule's value at n). The names
mapped are ``OPTIMIZERS`` and ``SCHEDULES``, with optax's defaults; any
other name raises and names itself once a parameter falls into the default
group (the JAX package never reads them otherwise).

Clipping composes as in the optax chain, by global norm and then by value,
over the gradient of every parameter that has one, as optax clips the whole
gradient tree before ``multi_transform``: a table the step updates outside
the optimizer still counts in the norm that scales the others.

``gradient_accumulation_steps`` k > 1 is ``optax.MultiSteps``: each call of
``step`` folds the gradients into their running mean (``acc + (g - acc) /
(n + 1)``, n the micro-step); the k-th call clips that mean, steps the
optimizers (and the schedules) and starts a new mean; the other calls leave
the parameters as they are.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
from recommendations_tpu_torch.parallel import collectives as col
from recommendations_tpu_torch.train.sparse_table import bias_corrections


def global_norm(grads: List[torch.Tensor], sharded: Optional[Dict[int, object]] = None) -> torch.Tensor:
    """The norm of every gradient together. ``sharded`` maps ``id`` of a
    gradient that is this rank's block of a parameter split over a process
    group to that group: its squares are summed over the group, the others'
    counted once."""
    sharded = sharded or {}
    squares = [g.float().square().sum() for g in grads if id(g) not in sharded]
    by_group: Dict[object, List[torch.Tensor]] = {}
    for g in grads:
        if id(g) in sharded:
            by_group.setdefault(sharded[id(g)], []).append(g.float().square().sum())
    for group, sq in by_group.items():
        total = torch.stack(sq).sum()
        col.all_reduce_(total, group)
        squares.append(total)
    return torch.stack(squares).sum().sqrt()


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sharded: Optional[Dict[int, object]] = None) -> None:
    """``optax.clip_by_global_norm``, in place: every gradient scaled by
    max_norm / ||g|| when the global norm ||g|| is at least max_norm
    (``sharded`` as for ``global_norm``)."""
    if not grads:
        return
    g_norm = global_norm(grads, sharded)
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / g_norm.to(g.dtype) * max_norm))


def clip_by_value(grads: List[torch.Tensor], max_abs: float) -> None:
    """``optax.clip``, in place."""
    for g in grads:
        g.clamp_(-max_abs, max_abs)


# -- the optax names the trainer config may give --------------------------------


def _optax_attr(clazz: str, kind: str, known: Dict[str, Callable]) -> Callable:
    """``optax.<name>`` (or a bare name, which optax's reflection also
    resolves in optax) -> its entry in ``known``."""
    module, _, attr = clazz.rpartition(".")
    if module not in ("", "optax") or attr not in known:
        raise NotImplementedError(
            f"{kind} {clazz!r} is not mapped in the port; mapped: {sorted('optax.' + k for k in known)}"
        )
    return known[attr]


def _adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, nesterov=False):
    if eps_root or nesterov:
        raise NotImplementedError("optax.adam with eps_root or nesterov is not mapped in the port")
    return "adamw", dict(lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=0.0)


def _adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4, nesterov=False):
    if eps_root or nesterov:
        raise NotImplementedError("optax.adamw with eps_root or nesterov is not mapped in the port")
    return "adamw", dict(lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay)


def _sgd(learning_rate, momentum=None, nesterov=False):
    return "sgd", dict(lr=learning_rate, momentum=momentum or 0.0, nesterov=bool(nesterov))


OPTIMIZERS: Dict[str, Callable] = {"adam": _adam, "adamw": _adamw, "sgd": _sgd}


def constant_schedule(value):
    return lambda count: float(value)


def linear_schedule(init_value, end_value, transition_steps, transition_begin=0):
    """``optax.linear_schedule`` (``polynomial_schedule`` at power 1)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)
    transition_begin = max(0, transition_begin)

    def schedule(count):
        c = min(max(count - transition_begin, 0), transition_steps)
        return (init_value - end_value) * (1 - c / transition_steps) + end_value

    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0, exponent=1.0):
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine**exponent + alpha)

    return schedule


def exponential_decay(init_value, transition_steps, decay_rate, transition_begin=0, staircase=False,
                      end_value=None):
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)
    transition_begin = max(0, transition_begin)

    def schedule(count):
        c = count - transition_begin
        p = c / transition_steps
        if staircase:
            p = math.floor(p)
        value = init_value if c <= 0 else init_value * decay_rate**p
        if end_value is not None:
            value = max(value, end_value) if decay_rate < 1.0 else min(value, end_value)
        return value

    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps, decay_steps, end_value=0.0, exponent=1.0):
    """A linear warm-up to ``peak_value`` joined to a cosine decay at
    ``warmup_steps`` (optax's ``join_schedules``)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha=alpha, exponent=exponent)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)


SCHEDULES: Dict[str, Callable] = {
    "constant_schedule": constant_schedule,
    "linear_schedule": linear_schedule,
    "cosine_decay_schedule": cosine_decay_schedule,
    "exponential_decay": exponential_decay,
    "warmup_cosine_decay_schedule": warmup_cosine_decay_schedule,
}


def default_group(tc: ModelTrainConfig) -> Tuple[str, dict, Optional[Callable[[int], float]]]:
    """``_default_tx``: (optimizer kind, its torch settings, the learning
    rate's schedule or None) of the parameters no group claims."""
    if tc.optimizer_clazz:
        kwargs = dict(tc.optimizer_kwargs or {})
        kwargs.setdefault("learning_rate", tc.learning_rate)
        kind, settings = _optax_attr(tc.optimizer_clazz, "optimizer_clazz", OPTIMIZERS)(**kwargs)
        return kind, settings, None
    schedule = None
    if tc.lr_scheduler_clazz:
        schedule = _optax_attr(tc.lr_scheduler_clazz, "lr_scheduler_clazz", SCHEDULES)(
            **(tc.lr_scheduler_kwargs or {})
        )
    wd = tc.weight_decay or 0.0
    kind, settings = (_adamw(tc.learning_rate, weight_decay=wd) if wd else _adam(tc.learning_rate))
    if schedule is not None:
        settings["lr"] = 1.0  # LambdaLR scales the group's initial lr by the schedule's value
    return kind, settings, schedule


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
    """The optimizers of the parameter groups: ``inner`` (AdamW over the
    model's main groups), ``table`` (``RowwiseAdam`` over a rowwise group)
    and ``default`` (the trainer config's optimizer over the parameters no
    group claims), each None when it has no parameter; the trainer config's
    clipping applied first to the gradients of ``clip_params`` (every
    parameter of the model), and with ``accumulate`` > 1 the running mean of
    that many calls' gradients stepped on every ``accumulate``-th call."""

    def __init__(
        self,
        inner: Optional[torch.optim.Optimizer],
        clip_norm: Optional[float],
        clip_value: Optional[float],
        table: Optional[torch.optim.Optimizer],
        clip_params: List[torch.nn.Parameter],
        default: Optional[torch.optim.Optimizer] = None,
        schedule: Optional[Callable[[int], float]] = None,
        accumulate: int = 1,
    ):
        self.inner, self.table, self.default = inner, table, default
        self.clip_norm, self.clip_value = clip_norm, clip_value
        self.clip_params = clip_params
        self.scheduler = (
            torch.optim.lr_scheduler.LambdaLR(default, schedule) if default is not None and schedule else None
        )
        self.accumulate = max(1, int(accumulate or 1))
        # parameters split over a process group -> that group, for the norm
        self.sharded_params: Dict[torch.nn.Parameter, object] = {}
        self.mini_step = 0  # optax.MultiSteps' mini_step
        self.acc: Dict[int, torch.Tensor] = {}  # parameter index -> running mean of its gradient

    def sharded_grads(self) -> Dict[int, object]:
        """``id`` of each sharded parameter's gradient -> its group."""
        return {id(p.grad): g for p, g in self.sharded_params.items() if p.grad is not None}

    def optimizers(self) -> List[torch.optim.Optimizer]:
        return [opt for opt in (self.inner, self.table, self.default) if opt is not None]

    def params(self) -> Iterable[torch.nn.Parameter]:
        for opt in self.optimizers():
            for group in opt.param_groups:
                yield from group["params"]

    def zero_grad(self) -> None:
        for p in self.clip_params:
            p.grad = None

    def _accumulate(self) -> bool:
        """Fold this call's gradients into the running mean; True when this
        call is the k-th, its gradients then being the mean."""
        n = self.mini_step
        for i, p in enumerate(self.clip_params):
            if p.grad is None and i not in self.acc:
                continue
            g = p.grad if p.grad is not None else torch.zeros_like(self.acc[i])
            acc = self.acc.get(i)
            if acc is None:
                acc = self.acc[i] = torch.zeros_like(g)
            # a 0-dim divisor on the device: a true division, as optax's
            acc.add_((g - acc) / torch.full((), n + 1, dtype=acc.dtype, device=acc.device))
        self.mini_step = (n + 1) % self.accumulate
        if self.mini_step:
            return False
        for i, p in enumerate(self.clip_params):
            if i in self.acc:
                p.grad = self.acc.pop(i)
        return True

    @torch.no_grad()
    def step(self) -> None:
        if self.accumulate > 1 and not self._accumulate():
            return
        grads = [p.grad for p in self.clip_params if p.grad is not None]
        if self.clip_norm:
            clip_by_global_norm(grads, self.clip_norm, self.sharded_grads())
        if self.clip_value:
            clip_by_value(grads, self.clip_value)
        for opt in self.optimizers():
            opt.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def state_dict(self) -> dict:
        """The optimizers' states and the accumulation (mini-step, means)."""
        return {
            "optimizers": [opt.state_dict() for opt in self.optimizers()],
            "scheduler": None if self.scheduler is None else self.scheduler.state_dict(),
            "mini_step": self.mini_step,
            "acc": dict(self.acc),
        }

    def load_state_dict(self, sd: dict) -> None:
        optimizers = self.optimizers()
        if len(optimizers) != len(sd["optimizers"]):
            raise ValueError(f"{len(sd['optimizers'])} optimizer states for {len(optimizers)} optimizers")
        for opt, opt_sd in zip(optimizers, sd["optimizers"]):
            opt.load_state_dict(opt_sd)
        if self.scheduler is not None:
            self.scheduler.load_state_dict(sd["scheduler"])
        self.mini_step = int(sd["mini_step"])
        self.acc = {int(i): t for i, t in sd["acc"].items()}


def build_optimizer(wrapper, train_config: ModelTrainConfig) -> TrainOptimizer:
    tc = train_config
    groups = wrapper.optimizers_for_param_groups() or {}
    labels = wrapper.param_labels()
    by_group = {}
    for name, p in wrapper.module.named_parameters():
        label = labels[name]
        settings = groups[label] if label in groups else None
        if (label in groups and settings is None) or not p.requires_grad:
            continue
        key = label if label in groups else "__default__"
        by_group.setdefault(key, (settings, []))[1].append(p)
    adamw, rowwise, default, schedule = [], [], None, None
    for key, (settings, ps) in by_group.items():
        if key == "__default__":
            # as in the JAX package, the reflection is read only where a
            # parameter falls into the default group
            default_kind, default_settings, schedule = default_group(tc)
            opt_cls = torch.optim.SGD if default_kind == "sgd" else torch.optim.AdamW
            default = opt_cls([dict(params=ps, **default_settings)])
            continue
        settings = dict(settings)
        kind = settings.pop("optimizer", "adamw")
        (rowwise if kind == "rowwise_adam" else adamw).append(dict(params=ps, **settings))
    inner = torch.optim.AdamW(adamw) if adamw else None
    table = RowwiseAdam(rowwise, lr=rowwise[0]["lr"]) if rowwise else None
    return TrainOptimizer(inner, tc.gradient_clip_norm, tc.gradient_clip_value, table,
                          list(wrapper.module.parameters()), default=default, schedule=schedule,
                          accumulate=tc.gradient_accumulation_steps or 1)
