"""Dropout in training (recommendations_tpu_torch.nn.dropout, through the
attention layers, the transformer and the LTHM) against the JAX package, on
the CPU.

Torch cannot draw jax.random's bits, so the masks are carried across: the
JAX side runs with its token masks (``_token_dropout_mask``, wrapped with
monkeypatch) and flax ``nn.Dropout``'s keep masks (captured with
``flax.linen.intercept_methods``) recorded in the order it draws them, and
the port replays them in that order through its own draw
(``nn.dropout.dropout_keep``). Then a 2-layer LTHM's loss and gradients
are held to JAX's at the f32 parity tolerances (tests/test_torch_train.py:
the loss 1e-4, each gradient 2e-4 norm-relative, the cosine-LSH tables one
bf16 ulp), on the ``_sdpa`` route, the flash route and the flash route with
the position bias. Also: the masks' (B, 1, T, 1) semantics and inverted
scaling, flax's arithmetic bit for bit, the keep rates, rate 0 changing
nothing, and remat recomputing the same masks (gradients bit-equal with
remat on and off)."""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.models.lthm.config import LTHMModelConfig as JaxConfig
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxWrapper
from recommendations_tpu.nn import attention as jatt
from recommendations_tpu.ops import fused_attention as jfa
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.nn import dropout as tdrop
from recommendations_tpu_torch.nn import transformer as ttr
from recommendations_tpu_torch.ops import fused_attention as tfa
from test_torch_production import tiny_batch, tiny_production_config
from test_torch_train import _check_grads, _grads_by_name, _offsets, small_batch, small_config

torch.set_num_threads(1)

TOL = 1e-4  # the loss, f32


def _jax_loss_with_recorded_masks(jw, vs, batch, rng, monkeypatch):
    """JAX's training loss and gradients, and the keep masks its forward
    drew, in order: ("token", (B,1,T,1)) and ("dropout", x.shape)."""
    masks = []
    real = jatt._token_dropout_mask

    def token_mask(key, rate, b, t):
        out = real(key, rate, b, t)
        masks.append(("token", np.asarray(out) > 0))
        return out

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        deterministic = kwargs.get("deterministic", args[1] if len(args) > 1 else None)
        deterministic = mod.deterministic if deterministic is None else deterministic
        if deterministic or mod.rate in (0.0, 1.0):
            return next_fun(*args, **kwargs)
        # one draw of the module's rng, on ones: the keep mask
        keep = np.asarray(next_fun(jnp.ones_like(x), *args[1:], **kwargs)) != 0
        masks.append(("dropout", keep))
        return jax.lax.select(jnp.asarray(keep), x / (1.0 - mod.rate), jnp.zeros_like(x))

    monkeypatch.setattr(jatt, "_token_dropout_mask", token_mask)

    def loss_fn(p):
        return jw.loss_and_metrics(p, vs["constants"], jw.init_aux_state(),
                                   {k: jnp.asarray(v) for k, v in batch.items()}, rng, True)

    with fnn.intercept_methods(interceptor):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(vs["params"])
    return float(loss), grads, masks


def _replay(monkeypatch, masks):
    """The port's draws return JAX's masks, in order; returns the list of
    (kind, shape) the port asked for."""
    pending = list(masks)
    asked = []

    def keep(generator, keep_prob, shape, device):
        kind, mask = pending.pop(0)
        asked.append((kind, tuple(shape)))
        assert tuple(mask.shape) == tuple(shape), (kind, mask.shape, shape)
        return torch.from_numpy(mask.copy()).to(device)

    monkeypatch.setattr(tdrop, "dropout_keep", keep)
    return asked, pending


def _lthm_pair(d):
    jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
    batch = small_batch() if d["context_width"] == 24 else tiny_batch(b=2, s=d["context_width"] + 8)
    vs = jw.init_variables(jax.random.PRNGKey(0), {k: jnp.asarray(v[:, :40]) for k, v in batch.items()})
    vs = jax.tree_util.tree_map(np.asarray, vs)
    for depth in range(2):
        attn = vs["params"]["query_tower"]["transformer"][f"block_{depth}"]["attn"]
        if "pos_bias" in attn:
            rs = np.random.RandomState(11 + depth)
            attn["pos_bias"]["bias"] = rs.randn(*attn["pos_bias"]["bias"].shape).astype(np.float32)
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
    tw.load_jax_variables(vs)
    return jw, vs, tw, batch


BIAS_T = 64  # T = window with the CLS column: both packages take the fused bias path below


def _route_config(route):
    if route == "flash_bias":
        d = tiny_production_config(BIAS_T - 1, "float32")
        d["transformer_config"]["enable_gradient_checkpointing"] = False  # JAX's masks are recorded outside remat
    else:
        d = small_config(use_flash=(route == "flash"))
    d["transformer_config"]["attn_config"].update(dropout=0.1, attn_dropout=0.1)
    return d


@pytest.mark.parametrize("route", ["sdpa", "flash", "flash_bias"])
def test_lthm_loss_and_grads_with_jax_masks_match_jax(route, monkeypatch):
    if route == "flash_bias":
        monkeypatch.setattr(jfa, "BIAS_MIN_SEQ", BIAS_T)
        monkeypatch.setattr(tfa, "BIAS_MIN_SEQ", BIAS_T)
    d = _route_config(route)
    jw, vs, tw, batch = _lthm_pair(d)
    rng = jax.random.PRNGKey(7)
    jl, jg, masks = _jax_loss_with_recorded_masks(jw, vs, batch, rng, monkeypatch)
    # the stack's input, then per block q, k, v, the attention output and the MLP output
    kinds = [k for k, _ in masks]
    assert kinds == ["dropout"] + ["token"] * 3 + ["dropout"] * 2 + ["token"] * 3 + ["dropout"] * 2
    drops = [m for k, m in masks if k == "dropout"]
    assert all(0.8 < m.mean() < 0.97 for m in drops)  # rate 0.1
    asked, left = _replay(monkeypatch, masks)
    calls = []
    if route != "sdpa":
        real = tfa.fused_flash_attention_bias_fwd if route == "flash_bias" else tfa.fused_flash_attention_fwd
        name = "fused_flash_attention_bias_fwd" if route == "flash_bias" else "fused_flash_attention_fwd"
        monkeypatch.setattr(tfa, name, lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tl, _, _ = tw.loss_and_metrics(batch, tw.init_aux_state(), True, offsets=_offsets(rng, d["lookahead"]),
                                   dropout_seed=5)
    tl.backward()
    assert not left and [k for k, _ in asked] == kinds
    assert len(calls) == (0 if route == "sdpa" else 2)  # the route each layer took
    assert abs(tl.item() - jl) <= TOL
    _check_grads(tw, _grads_by_name(tw, jg, vs))


def test_token_mask_semantics_and_inverted_scale():
    """(B, 1, T, 1) float32 masks of 0 and 1/f32(1 - rate), one per q, k and
    v, each shared by every head of a token; the product is taken in float32
    and cast back, as JAX's ``(x * do[:, 0]).astype(x.dtype)``."""
    g = torch.Generator().manual_seed(3)
    m = tdrop.token_dropout_mask(g, 0.25, 4, 9, "cpu")
    assert m.shape == (4, 1, 9, 1) and m.dtype == torch.float32
    assert set(m.unique().tolist()) <= {0.0, float(np.float32(1) / np.float32(0.75))}
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(4, 9, 4 * 16).astype(np.float32)).to(torch.bfloat16) for _ in range(3))
    seen = []
    real = tdrop.token_dropout_mask

    def record(*a):
        seen.append(real(*a))
        return seen[-1]

    tdrop.token_dropout_mask = record
    try:
        outs = tdrop.qkv_dropout(q, k, v, 0.25, torch.Generator().manual_seed(4))
    finally:
        tdrop.token_dropout_mask = real
    assert len(seen) == 3 and not all(torch.equal(seen[0], s) for s in seen[1:])
    for x, mask, out in zip((q, k, v), seen, outs):
        want = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) * jnp.asarray(mask.numpy())[:, 0]).astype(
            jnp.bfloat16)
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(want.astype(jnp.float32)))
        heads = out.float().reshape(4, 9, 4, 16)
        dropped = mask[:, 0, :, 0] == 0
        assert bool((heads[dropped] == 0).all())  # a dropped token loses every head


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_arithmetic_equals_flax(dtype, rate, monkeypatch):
    """flax ``nn.Dropout``: select(keep, x / keep_prob, 0), the division in
    x's dtype; given flax's keep mask the port gives its bits."""
    rs = np.random.RandomState(1)
    x = rs.randn(3, 7, 24).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    mod = fnn.Dropout(rate, deterministic=False)
    key = jax.random.PRNGKey(2)
    want = mod.apply({}, jnp.asarray(x).astype(jdt), rngs={"dropout": key})
    keep = np.asarray(mod.apply({}, jnp.ones(x.shape, jdt), rngs={"dropout": key})) != 0
    monkeypatch.setattr(tdrop, "dropout_keep", lambda g, p, shape, device: torch.from_numpy(keep.copy()))
    got = tdrop.dropout(torch.from_numpy(x).to(dtype), rate, None)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_rate_one_gives_zeros_and_rate_zero_changes_nothing():
    x = torch.randn(2, 5, 8).to(torch.bfloat16)
    assert torch.equal(tdrop.dropout(x, 1.0, None), torch.zeros_like(x))
    assert tdrop.dropout(x, 0.0, None) is x
    assert tdrop.qkv_dropout(x, x, x, 0.0, None) == (x, x, x)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(tdrop.token_dropout_mask(g, 0.0, 2, 5, "cpu"), torch.ones(2, 1, 5, 1))


def test_zero_rates_train_exactly_as_serving_forward():
    """Rates 0 draw no mask: the training forward equals the serving
    forward bit for bit."""
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(small_config(False)), device="cpu", seed=2)
    batch = tw.format_inputs(small_batch())
    with torch.no_grad():
        train = tw.module(batch, training=True, dropout_seed=9)
        serve = tw.module(batch, training=False)
    for key in ("next_token_emb", "current_token_emb"):
        assert torch.equal(train[key], serve[key])


@pytest.mark.parametrize("rate,n", [(0.1, 200_000), (0.5, 100_000)])
def test_keep_rates(rate, n):
    """Both draws keep 1 - rate of their elements, within 4 binomial
    standard deviations."""
    g = torch.Generator().manual_seed(11)
    sd = np.sqrt(rate * (1 - rate) / n)
    token = (tdrop.token_dropout_mask(g, rate, n // 100, 100, "cpu") > 0).float().mean().item()
    drop = (tdrop.dropout(torch.ones(n // 100, 100), rate, g) != 0).float().mean().item()
    for kept in (token, drop):
        assert abs(kept - (1 - rate)) <= 4 * sd, kept


def test_a_training_forward_with_dropout_needs_a_seed():
    d = small_config(True)
    d["transformer_config"]["attn_config"].update(dropout=0.1)
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(d), device="cpu", seed=2)
    batch = tw.format_inputs(small_batch())
    with pytest.raises(ValueError, match="dropout seed"):
        tw.module(batch, training=True)
    tw.module(batch, training=False)  # serving applies no dropout
    a = tw.module(batch, training=True, dropout_seed=1)["next_token_emb"]
    b = tw.module(batch, training=True, dropout_seed=1)["next_token_emb"]
    c = tw.module(batch, training=True, dropout_seed=2)["next_token_emb"]
    assert torch.equal(a, b) and not torch.equal(a, c)


def _stack_grads(remat, policy, bias, seed=21):
    t = 40
    stack = ttr.TransformerStack(2, 32, 4, torch.Generator().manual_seed(1), remat=remat, remat_policy=policy,
                                 attn_type="multi_query", is_causal=True, use_bias=False,
                                 pos_bias_window=t if bias else None, use_flash=True, dropout=0.1,
                                 attn_dropout=0.2)
    x = torch.randn(2, t, 32, generator=torch.Generator().manual_seed(2), requires_grad=True)
    stack(x, training=True, dropout_seed=seed).square().sum().backward()
    return [x.grad] + [p.grad for p in stack.parameters()]


@pytest.mark.parametrize("policy", ["dots_no_batch", "full"])
@pytest.mark.parametrize("bias", [False, True])
def test_remat_recomputes_the_same_masks(policy, bias):
    """Under remat each block runs again in the backward and draws its masks
    again from its seed: the gradients equal remat off's bit for bit."""
    plain = _stack_grads(False, policy, bias)
    remat = _stack_grads(True, policy, bias)
    assert len(plain) == len(remat)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)
    other = _stack_grads(False, policy, bias, seed=22)
    assert not torch.equal(plain[0], other[0])
