"""The port's optimizer assembly (recommendations_tpu_torch/train/optimizers.py)
against the JAX package's optax chains, on the CPU: gradient accumulation
as ``optax.MultiSteps`` (the running mean, clipping applied to it, the
optimizers stepping on every k-th call) at the optimizer and through eight
LTHM training steps with the lazy and the fused table, whose updates run
on every micro-step; ``_default_tx``'s reflection (``optimizer_clazz``,
``lr_scheduler_clazz``) for a model that claims no parameter group, each
mapped schedule's learning rate at steps 0-50 and each mapped optimizer's
parameters after 5 steps; and the names it does not map."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommendations_tpu.config.trainer_config import ModelTrainConfig as JaxTrainConfig
from recommendations_tpu.models.base import DEFAULT_OPTIM_GROUP, BaseModelWrapper
from recommendations_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from recommendations_tpu.train.train_state import TrainState as JaxTrainState
from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
from recommendations_tpu_torch.models.lthm import loss as tloss
from recommendations_tpu_torch.train import optimizers as topt
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState
from test_torch_table import _jax_ce_operands, _jax_step, _leaves_of, _norm_rel, _substituting_ce, _table_pair
from test_torch_train import GRAD_TOL, TOL, _offsets, small_batch, small_config

torch.set_num_threads(1)


class _JaxPlain(BaseModelWrapper):
    """A model that claims no parameter group (tests/test_optimizers.py's)."""

    def init_variables(self, rng, batch):
        return {}

    def forward(self, variables, batch, rng=None, deterministic=True):
        return None

    def loss_and_metrics(self, *a, **k):
        raise NotImplementedError

    def param_labels(self, params):
        return jax.tree_util.tree_map(lambda _: DEFAULT_OPTIM_GROUP, params)

    def optimizers_for_param_groups(self):
        return None


class _PortPlain:
    """The port's counterpart: a module of two parameters, no group."""

    def __init__(self, params):
        self.module = torch.nn.Module()
        for name, value in params.items():
            self.module.register_parameter(name, torch.nn.Parameter(torch.from_numpy(np.array(value))))

    def param_labels(self):
        return {name: "default" for name, _ in self.module.named_parameters()}

    def optimizers_for_param_groups(self):
        return None


def _params():
    rs = np.random.RandomState(0)
    return {"w": rs.randn(6, 5).astype(np.float32), "b": rs.randn(5).astype(np.float32)}


def _run_both(jcfg, tcfg, steps, grad_scale=1.0, seed=1):
    """``steps`` updates of both optimizers fed the same gradients; returns
    (JAX params, port module, JAX opt state, port optimizer)."""
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    jtx = jax_build_optimizer(_JaxPlain(), JaxTrainConfig(**jcfg), params)
    jstate = jtx.init(params)
    pw = _PortPlain(_params())
    ptx = topt.build_optimizer(pw, ModelTrainConfig(**tcfg))
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        grads = {k: (rs.randn(*v.shape) * grad_scale).astype(np.float32) for k, v in _params().items()}
        updates, jstate = jtx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, params)
        params = optax.apply_updates(params, updates)
        for name, p in pw.module.named_parameters():
            p.grad = torch.from_numpy(grads[name].copy())
        ptx.step()
    return params, pw.module, jstate, ptx


def _assert_params(jparams, module, atol=1e-6):
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[name]), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("clip", [{}, {"gradient_clip_norm": 0.5}, {"gradient_clip_value": 0.3}])
def test_accumulation_matches_optax_multisteps(clip):
    """k = 4 over 8 calls: parameters move on calls 4 and 8 only, by the
    optimizer's step on the clipped running mean."""
    cfg = dict(gradient_accumulation_steps=4, learning_rate=0.01, weight_decay=1e-3, **clip)
    for steps in (3, 4, 7, 8):
        jp, module, jstate, ptx = _run_both(cfg, cfg, steps, grad_scale=2.0)
        _assert_params(jp, module)
        assert ptx.mini_step == int(jstate.mini_step) == steps % 4
        assert int(jstate.gradient_step) == steps // 4
        counts = {int(s["step"]) for s in ptx.default.state.values()}
        assert counts == ({steps // 4} if steps >= 4 else set())
        if steps == 7:  # the running mean of calls 5-7: optax's acc_grads
            for idx, (name, _) in enumerate(module.named_parameters()):
                np.testing.assert_allclose(ptx.acc[idx].numpy(), np.asarray(jstate.acc_grads[name]), rtol=0,
                                           atol=1e-6)


def test_accumulation_state_survives_a_checkpoint():
    """The mean and the mini-step go through state_dict, so a run resumed
    mid-accumulation gives the uninterrupted run's bits."""
    cfg = dict(gradient_accumulation_steps=3, learning_rate=0.01)
    _, m_full, _, _ = _run_both(cfg, cfg, 5)
    pw = _PortPlain(_params())
    ptx = topt.build_optimizer(pw, ModelTrainConfig(**cfg))
    rs = np.random.RandomState(1)
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in _params().items()} for _ in range(5)]
    sd = None
    for i, g in enumerate(grads):
        if i == 2:
            sd = ptx.state_dict()
            pw2 = _PortPlain({n: p.detach().numpy() for n, p in pw.module.named_parameters()})
            ptx = topt.build_optimizer(pw2, ModelTrainConfig(**cfg))
            ptx.load_state_dict(sd)
            pw = pw2
        for name, p in pw.module.named_parameters():
            p.grad = torch.from_numpy(g[name].copy())
        ptx.step()
    for (name, a), (_, b) in zip(m_full.named_parameters(), pw.module.named_parameters()):
        assert torch.equal(a, b), name
    assert sd["mini_step"] == 2 and len(sd["acc"]) == 2


@pytest.mark.parametrize("table_optimizer", ["lazy_rowwise_adam", "sparse_fused_adam"])
def test_eight_accumulated_train_steps_match_jax(table_optimizer):
    """The small LTHM (f32, detach_item_tower false) for 8 steps at k = 4
    and clip norm 1.0 in both packages, from one initial state: each step's
    loss within 1e-4; ``state.step`` and the table's lazy or fused state
    advance on every micro-step, the AdamW count on every 4th; the dense
    parameters move on steps 4 and 8 only, the table on every step; after
    step 8 every parameter's change and the table state within 2e-4
    norm-relative. As in tests/test_torch_table.py's clip-0.5 steps, the
    port's CE reads JAX's bf16 operands in value, each asserted to lie at
    most one bf16 step from the port's own: once the parameters have moved,
    a few of the CE's L2-normalized operands sit within f32 rounding of a
    bf16 rounding edge (ROADMAP section 3, a limit of parity)."""
    d = small_config(False, "float32", beta=0.5, mini_batch=3, table_optimizer=table_optimizer)
    d["product_tower"]["detach_item_tower"] = False
    jw, vs, tw = _table_pair(d)
    clip = {"gradient_clip_norm": 1.0, "gradient_accumulation_steps": 4}
    jopt = jax_build_optimizer(jw, JaxTrainConfig(**clip), vs["params"])
    jstate = JaxTrainState.create(vs["params"], vs.get("constants", {}), jopt.init(vs["params"]), jw.init_aux_state(),
                                  jax.random.PRNGKey(1), table_state=jw.init_table_state(vs["params"]))
    tstate = TrainState.create(tw, ModelTrainConfig(**clip))
    start = {name: p.detach().clone() for name, p in tw.module.named_parameters()}
    table_name = "product_emb_module.embedding"
    for step in range(8):
        batch = small_batch(seed=step % 2)
        before = {name: p.detach().clone() for name, p in tw.module.named_parameters()}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        flips = []
        ce = _substituting_ce(_jax_ce_operands(jw, jstate, jbatch), flips)
        jstate, jl, _, sub = _jax_step(jw, jopt, jstate, jbatch)
        with mock.patch.object(tloss, "_ce_rows", ce):
            tl, _ = train_step(tstate, batch, offsets=_offsets(sub, d["lookahead"]))
        assert sum(flips) <= 32, flips
        assert abs(float(tl) - float(jl)) <= TOL, step
        assert tstate.step == int(jstate.step) == step + 1
        assert int(tstate.table_state.count) == int(jstate.table_state.count) == step + 1
        emit = (step + 1) % 4 == 0
        for name, p in tw.module.named_parameters():
            moved = not torch.equal(p.detach(), before[name])
            assert moved == (emit or name == table_name), (name, step)
        counts = {int(s["step"]) for s in tstate.optimizer.inner.state.values()}
        assert counts == ({(step + 1) // 4} if step >= 3 else set())
    (ms,) = _leaves_of(jstate.opt_state, optax.MultiStepsState)
    assert int(ms.gradient_step) == 2 and int(ms.mini_step) == 0
    want = jax.tree_util.tree_map(np.asarray, {"params": jstate.params, "constants": jstate.constants})
    from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax

    want = state_dict_from_jax(want, tw.module)
    for name, p in tw.module.named_parameters():
        err = _norm_rel((p.detach() - start[name]).numpy(), (want[name] - start[name]).numpy())
        assert err <= GRAD_TOL, f"{name}: change error {err:.3e}"
    if table_optimizer == "lazy_rowwise_adam":
        assert _norm_rel(tstate.table_state.m.numpy(), np.asarray(jstate.table_state.m)) <= GRAD_TOL
        assert _norm_rel(tstate.table_state.v.numpy(), np.asarray(jstate.table_state.v)) <= GRAD_TOL


SCHEDULES = [
    ("optax.constant_schedule", dict(value=0.03)),
    ("optax.linear_schedule", dict(init_value=0.1, end_value=0.001, transition_steps=30, transition_begin=5)),
    ("optax.cosine_decay_schedule", dict(init_value=0.1, decay_steps=40, alpha=0.1)),
    ("optax.cosine_decay_schedule", dict(init_value=0.1, decay_steps=40, exponent=2.0)),
    ("optax.exponential_decay", dict(init_value=0.1, transition_steps=7, decay_rate=0.5, transition_begin=3)),
    ("optax.exponential_decay", dict(init_value=0.1, transition_steps=7, decay_rate=0.5, staircase=True,
                                     end_value=0.01)),
    ("optax.warmup_cosine_decay_schedule", dict(init_value=0.0, peak_value=0.1, warmup_steps=10, decay_steps=45,
                                                end_value=0.001)),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULES)
def test_schedule_learning_rates_match_optax(name, kwargs):
    """The learning rate the default group's ``LambdaLR`` sets before each
    of steps 0-50 against the optax schedule's value at that count."""
    want = getattr(optax, name.split(".")[1])(**kwargs)
    pw = _PortPlain(_params())
    ptx = topt.build_optimizer(pw, ModelTrainConfig(lr_scheduler_clazz=name, lr_scheduler_kwargs=kwargs))
    for count in range(51):
        got = ptx.default.param_groups[0]["lr"]
        np.testing.assert_allclose(got, float(want(count)), rtol=1e-6, atol=1e-9, err_msg=f"count {count}")
        for p in pw.module.parameters():
            p.grad = torch.zeros_like(p)
        ptx.step()


OPTIMIZER_CASES = [
    dict(optimizer_clazz="optax.adam"),
    dict(optimizer_clazz="optax.adamw"),
    dict(optimizer_clazz="optax.adamw", optimizer_kwargs={"weight_decay": 0.05, "b1": 0.8, "eps": 1e-6}),
    dict(optimizer_clazz="optax.sgd"),
    dict(optimizer_clazz="optax.sgd", optimizer_kwargs={"momentum": 0.9, "nesterov": True}),
    dict(optimizer_clazz="adam", optimizer_kwargs={"learning_rate": 0.05}),  # a bare name resolves in optax
    dict(),  # Adam at the config's rate
    dict(weight_decay=0.01),  # AdamW
    dict(weight_decay=0.01, lr_scheduler_clazz="optax.cosine_decay_schedule",
         lr_scheduler_kwargs={"init_value": 0.02, "decay_steps": 4}),
    dict(gradient_clip_norm=1.0, lr_scheduler_clazz="optax.linear_schedule",
         lr_scheduler_kwargs={"init_value": 0.02, "end_value": 0.0, "transition_steps": 5}),
]


@pytest.mark.parametrize("cfg", OPTIMIZER_CASES)
def test_mapped_optimizers_match_optax_after_five_steps(cfg):
    jp, module, _, _ = _run_both(dict(learning_rate=0.01, **cfg), dict(learning_rate=0.01, **cfg), 5)
    _assert_params(jp, module)


@pytest.mark.parametrize("cfg,name", [
    (dict(optimizer_clazz="optax.lion"), "optax.lion"),
    (dict(optimizer_clazz="torch.optim.Adam"), "torch.optim.Adam"),
    (dict(lr_scheduler_clazz="optax.sgdr_schedule"), "optax.sgdr_schedule"),
])
def test_unmapped_names_raise_and_name_themselves(cfg, name):
    with pytest.raises(NotImplementedError, match=name.replace(".", r"\.")):
        topt.build_optimizer(_PortPlain(_params()), ModelTrainConfig(**cfg))
