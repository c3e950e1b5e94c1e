"""The port's LTHM training path (loss_and_metrics, the optimizer, the train
step, the state converters) against the JAX package's, on the CPU, with the
same weights, batch and lookahead offsets; and the repairs the training path
needed (the flash backward, the product tower's stop-gradient).

The JAX side runs op by op: compiled, XLA's CPU backend drops the bf16
storage of the logits GEMM that ``models/lthm/loss.py:63-72`` prescribes
(see tests/test_torch_loss.py), and JAX compiles the loss chunks when they
divide the batch (its scan), so more than one chunk is tested here with a
ragged last chunk, which JAX runs in a python loop; test_torch_loss.py holds
the scan case op by op."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommendations_tpu.config.trainer_config import ModelTrainConfig as JaxTrainConfig
from recommendations_tpu.models.lthm.config import LTHMModelConfig as JaxConfig
from recommendations_tpu.models.lthm.loss import sample_offsets
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxWrapper
from recommendations_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from recommendations_tpu.train.train_state import TrainState as JaxTrainState
from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.convert import (
    adamw_state_from_jax,
    aux_state_from_jax,
    state_dict_from_jax,
)
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.train.optimizers import build_optimizer
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState

torch.set_num_threads(1)

TOL = 1e-4       # loss and metrics, f32
GRAD_TOL = 2e-4  # each parameter's gradient, norm-relative, f32
# The cosine-LSH tables' gradient is a bf16 product with a bf16 output in
# both packages even in a float32 model (recommendations_tpu/nn/lsh.py:
# 117-119, compute_dtype bf16): held at one bf16 ulp, norm-relative.
LSH_GRAD_TOL = 2**-8


def small_config(use_flash=True, compute_dtype="float32", beta=0.0, mini_batch=-1, **over):
    """2 layers, d=64, MQA with 4 heads, context 24, three lookahead heads."""
    d = dict(
        features={"defaults": {}},
        compute_dtype=compute_dtype,
        transformer_config=dict(
            rotator_config={"ff_mult": 4},
            is_causal=True,
            num_layers=2,
            use_flash_attention=use_flash,
            attn_config=dict(
                n_head=4, n_embd=64, attn_type="multi_query",
                dropout=0.0, attn_dropout=0.0, bias=False,
            ),
        ),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=64, product_emb_dim=32, norm_bins=8,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 16}, {"num_bins": 8, "num_proj": 16}],
            latent_model_config={
                "vocab_size_latent": 5000, "num_shifts_latent": 4, "normalize_embedding": True,
            },
        ),
        log_q_config={"num_buckets": 64, "hash_offsets": [0, 7], "beta": beta},
        lookahead=[0, 2, 4],
        context_width=24,
        train_mini_batch_size=mini_batch,
        table_optimizer="frozen",
        lr=1e-3,
        weight_decay=1e-3,
    )
    d.update(over)
    return d


def small_batch(b=4, s=30, seed=0):
    """Right-padded histories (pad id 0), float32 labels and timestamps."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(-(2**62), 2**62, size=(b, s)).astype(np.int64)
    ids[:, -3:] = 0
    ids[1, 20:] = 0
    return {
        "product_ids": ids,
        "labels": rs.randint(0, 4, size=(b, s)).astype(np.float32),
        "timestamps": rs.randint(1_600_000_000, 1_700_000_000, size=(b, s)).astype(np.float32),
    }


_JAX_MODELS = {}


def _pair(d):
    """(JAX wrapper, variables, port wrapper with the same weights); the JAX
    side is built once per configuration."""
    key = repr(d)
    if key not in _JAX_MODELS:
        jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
        batch = {k: jnp.asarray(v) for k, v in small_batch().items()}
        _JAX_MODELS[key] = jw, jw.init_variables(jax.random.PRNGKey(0), batch)
    jw, vs = _JAX_MODELS[key]
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
    tw.load_jax_variables(jax.tree_util.tree_map(np.asarray, vs))
    return jw, vs, tw


def _offsets(rng, lookahead):
    """The offsets JAX's loss_and_metrics draws from ``rng``."""
    return np.asarray(sample_offsets(jax.random.split(rng)[1], lookahead))


def _grads_by_name(tw, jgrads, vs):
    return state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads),
         "constants": jax.tree_util.tree_map(np.asarray, vs["constants"])},
        tw.module,
    )


def _check_grads(tw, want_by_name, tol=GRAD_TOL, lsh_tol=LSH_GRAD_TOL):
    for name, p in tw.module.named_parameters():
        want = want_by_name[name].numpy()
        if name.startswith("product_emb_module."):
            assert p.grad is None and not np.any(want), name  # frozen, detached table
            continue
        got = p.grad.numpy()
        limit = lsh_tol if ".direction_emb_" in name else tol
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= limit, f"{name}: relative error {err:.3e} > {limit}"


def _check_metrics(tm, jm):
    """Every key at 1e-4, but the rank metrics: a rank counts the logits
    above the positive's, both stored in bf16, where ties are common, so a
    forward difference of 1e-6 can flip one. Held at one flip per head: 1 /
    used tokens for the mean rank and the hit rates, one rank for the median.
    (tests/test_torch_loss.py holds them at 1e-4 on identical CE inputs.)"""
    assert set(tm) >= set(jm)
    for key in jm:
        tol = TOL
        if "hit_" in key:
            head = key.rsplit("_", 1)[-1]
            used = float(jm[f"train_used_tokens_lookahead_{head}"])
            tol = 1.0 if "median" in key else max(TOL, 1.0 / used)
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=0, atol=tol, err_msg=key)


@pytest.mark.parametrize(
    "use_flash,beta,mini_batch",
    [(True, 0.0, -1), (False, 0.5, 3)],
)
def test_loss_metrics_and_grads_match_jax_f32(use_flash, beta, mini_batch):
    d = small_config(use_flash, "float32", beta, mini_batch)
    jw, vs, tw = _pair(d)
    batch = small_batch()
    rng = jax.random.PRNGKey(3)
    aux = jw.init_aux_state()

    def loss_fn(p):
        return jw.loss_and_metrics(p, vs["constants"], aux, {k: jnp.asarray(v) for k, v in batch.items()}, rng, True)

    (jl, (jm, jaux)), jg = jax.value_and_grad(loss_fn, has_aux=True)(vs["params"])
    tl, tm, taux = tw.loss_and_metrics(batch, tw.init_aux_state(), True, offsets=_offsets(rng, d["lookahead"]))
    tl.backward()
    assert abs(tl.item() - float(jl)) <= TOL
    _check_metrics(tm, jm)
    _check_grads(tw, _grads_by_name(tw, jg, vs))
    np.testing.assert_array_equal(taux.logq.b.numpy(), np.asarray(jaux.logq.b))
    np.testing.assert_array_equal(taux.logq.a.numpy(), np.asarray(jaux.logq.a))
    assert float(taux.batch_idx) == float(jaux.batch_idx) == 1.0


def test_grads_match_jax_bf16():
    """bf16 compute (the flash backward in bf16 is held on its own in
    test_torch_flash_bwd.py): the packages round at different points inside
    fused ops, so ulp flips in the forward (held in test_torch_lthm.py at
    2**-6 of the largest output) travel into the gradients. Held: the loss
    within 1e-2, and each parameter's gradient within 2**-4 norm-relative."""
    d = small_config(False, "bfloat16")
    jw, vs, tw = _pair(d)
    batch = small_batch()
    rng = jax.random.PRNGKey(4)

    def loss_fn(p):
        return jw.loss_and_metrics(p, vs["constants"], jw.init_aux_state(), {k: jnp.asarray(v) for k, v in batch.items()}, rng, True)

    (jl, _), jg = jax.value_and_grad(loss_fn, has_aux=True)(vs["params"])
    tl, _, _ = tw.loss_and_metrics(batch, tw.init_aux_state(), True, offsets=_offsets(rng, d["lookahead"]))
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-2
    _check_grads(tw, _grads_by_name(tw, jg, vs), tol=2**-4, lsh_tol=2**-4)


def _leaves_of(tree, cls):
    return [x for x in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, cls)) if isinstance(x, cls)]


def _adam_state(opt_state):
    """The AdamW moments of the main group (USE_OPTIM) of JAX's optimizer."""
    (multi,) = _leaves_of(opt_state, optax.MultiTransformState)
    (adam,) = _leaves_of(multi.inner_states["USE_OPTIM"], optax.ScaleByAdamState)
    return adam


@pytest.mark.parametrize(
    "clip", [{}, {"gradient_clip_norm": 0.5}, {"gradient_clip_value": 1e-3}]
)
def test_optimizer_matches_optax(clip):
    """Both fed the same gradients for two steps; AdamW with weight decay,
    after the trainer config's clipping."""
    d = small_config(False)
    jw, vs, tw = _pair(d)
    params = vs["params"]
    jopt = jax_build_optimizer(jw, JaxTrainConfig(**clip), params)
    jstate = jopt.init(params)
    topt = build_optimizer(tw, ModelTrainConfig(**clip))
    rs = np.random.RandomState(0)
    for _ in range(2):
        grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32) * 0.1), params)
        grads["product_emb_module"] = jax.tree_util.tree_map(jnp.zeros_like, params["product_emb_module"])
        updates, jstate = jopt.update(grads, jstate, params)
        params = optax.apply_updates(params, updates)
        by_name = _grads_by_name(tw, grads, vs)
        for name, p in tw.module.named_parameters():
            p.grad = None if not p.requires_grad else by_name[name].clone()
        topt.step()
    want = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, params), "constants": jax.tree_util.tree_map(np.asarray, vs["constants"])},
        tw.module,
    )
    for name, p in tw.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
    adam = _adam_state(jstate)
    assert all(int(s["step"]) == int(adam.count) == 2 for s in topt.inner.state.values())


def _jax_step(jw, optimizer, state, batch):
    """The JAX step as bench.py:127-153 builds it, run op by op (no jit)."""
    rng, sub = jax.random.split(state.rng)

    def loss_fn(p):
        return jw.loss_and_metrics(p, state.constants, state.aux, batch, sub, True)

    (loss, (metrics, new_aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
    updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
    new_params = optax.apply_updates(state.params, updates)
    metrics = dict(metrics)
    metrics["grad_norm"] = jnp.sqrt(sum(jnp.sum(g**2) for g in jax.tree_util.tree_leaves(grads)))
    new_state = JaxTrainState(
        params=new_params, constants=state.constants, opt_state=new_opt, aux=new_aux,
        step=state.step + 1, rng=rng, table_state=None,
    )
    return new_state, loss, metrics, sub


def test_two_train_steps_match_jax():
    """Step 1 from one initial state; step 2 from the JAX state after step 1
    converted into the port (params, logQ state, AdamW moments and count)."""
    d = small_config(False, "float32", beta=0.5, mini_batch=3)
    jw, vs, tw = _pair(d)
    jbatch = {k: jnp.asarray(v) for k, v in small_batch().items()}
    jopt = jax_build_optimizer(jw, JaxTrainConfig(), vs["params"])
    jstate = JaxTrainState.create(
        vs["params"], vs["constants"], jopt.init(vs["params"]), jw.init_aux_state(), jax.random.PRNGKey(1)
    )
    tstate = TrainState.create(tw, ModelTrainConfig())
    for step in range(2):
        if step == 1:  # start the port from JAX's state
            np_vars = jax.tree_util.tree_map(np.asarray, {"params": jstate.params, "constants": jstate.constants})
            tw.load_jax_variables(np_vars)
            tstate.aux = aux_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate.aux))
            adam = _adam_state(jstate.opt_state)
            adamw_state_from_jax(
                jax.tree_util.tree_map(np.asarray, adam.mu), jax.tree_util.tree_map(np.asarray, adam.nu),
                adam.count, tw.module, tstate.optimizer.inner,
            )
        before = {name: p.detach().clone() for name, p in tw.module.named_parameters()}
        jstate, jl, jm, sub = _jax_step(jw, jopt, jstate, jbatch)
        tl, tm = train_step(tstate, small_batch(), offsets=_offsets(sub, d["lookahead"]))
        assert tstate.step == int(jstate.step) == step + 1
        assert abs(float(tl) - float(jl)) <= TOL, step
        _check_metrics(tm, {k: v for k, v in jm.items() if k != "grad_norm"})
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= GRAD_TOL * float(jm["grad_norm"])
        assert float(tm["params_nan"]) == 0.0
        want = state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, {"params": jstate.params, "constants": jstate.constants}), tw.module
        )
        for name, p in tw.module.named_parameters():
            # AdamW's step is lr * m/(sqrt(v) + eps) per element: about lr for
            # any gradient well above eps, so an element whose gradient sits
            # near eps turns the gradient's small absolute error into a large
            # relative one of its step. Each parameter's update is held
            # norm-relative, at the gradients' tolerance.
            got_step = (p.detach() - before[name]).numpy()
            want_step = (want[name] - before[name]).numpy()
            err = np.linalg.norm(got_step - want_step) / max(np.linalg.norm(want_step), 1e-30)
            assert err <= GRAD_TOL, f"{name}, step {step + 1}: update error {err:.3e}"
        np.testing.assert_array_equal(tstate.aux.logq.b.numpy(), np.asarray(jstate.aux.logq.b))
        np.testing.assert_array_equal(tstate.aux.logq.a.numpy(), np.asarray(jstate.aux.logq.a))


# -- the repairs ---------------------------------------------------------------


def test_product_tower_stops_the_table_gradient():
    """detach_item_tower (the default): no gradient reaches the KShift table
    (JAX: jax.lax.stop_gradient, models/lthm/model.py:52-53)."""
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(small_config(False)), device="cpu", seed=2)
    out = tw.module(tw.format_inputs(small_batch()))
    (out["next_token_emb"].sum() + out["current_token_emb"].sum()).backward()
    assert tw.module.product_emb_module.embedding.grad is None
    assert tw.module.product_tower.emb_mapper.weight.grad is not None


def test_zero_dropout_trains():
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(small_config(True)), device="cpu", seed=2)
    state = TrainState.create(tw)
    losses = [float(train_step(state, small_batch(), offsets=[0, 1, 3])[0]) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_no_silent_cpu_for_training(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainState.create(LTHMModelWrapper(LTHMModelConfig.from_dict(small_config(False))))
