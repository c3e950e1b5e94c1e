"""The production LTHM (configs/model/lthm.yaml: 16 layers with remat, a
relative-position bias, MQA 32x16) at the long-history context 1024 in the
port, against the JAX package, on the CPU.

The full-size model is built only on the card (chip_smoke.py); here its
config is held to the JAX package's, and a model of its shape cut to a few
narrow layers (2 layers, d=32, MQA with 4 heads, context 767 so that
T = 768 = the position-bias window, the fused bias path, remat on) serves and
takes a training step against JAX with the same weights (carried by
convert.py, the position-bias tables made nonzero). The JAX side runs its
Pallas bias kernels in interpret mode, op by op. float32 compute, so the
tolerances are the f32 parity tests' (tests/test_torch_train.py): the loss
at 1e-4, each gradient at 2e-4 norm-relative (the cosine-LSH tables, a bf16
product, at one bf16 ulp), outputs at 1e-4. The fused CE is held on its own
in tests/test_torch_fused_ce.py; this model uses the eager CE."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import production_config
from recommendations_tpu.models.lthm.config import LTHMModelConfig as JaxConfig
from recommendations_tpu.models.lthm.loss import sample_offsets
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxWrapper
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.nn import transformer as ttr
from recommendations_tpu_torch.ops import fused_attention as tfa

torch.set_num_threads(1)

CONTEXT = 767  # T = 768 with CLS: BIAS_MIN_SEQ, the fused bias path


def test_production_config_at_context_1024_matches_jax():
    d = production_config()
    tc = LTHMModelConfig.from_dict(copy.deepcopy(d))
    jc = JaxConfig(**copy.deepcopy(d)).model_dump()
    for name, val in dataclasses.asdict(tc).items():
        if name not in ("features", "kind"):
            assert val == jc[name], name
    t = tc.transformer_config
    assert (t.num_layers, t.enable_gradient_checkpointing, t.remat_policy) == (16, True, "dots_no_batch")
    assert (t.attn_config.n_embd, t.attn_config.n_head, t.attn_config.attn_type) == (512, 32, "multi_query")
    assert t.attn_config.pos_bias.context_window == 1025 and tc.context_width == 1024
    assert tc.product_tower.latent_model_config.vocab_size_latent == 10_000_000
    assert tc.resolved_table_optimizer() == "frozen" and tc.fused_ce
    assert tfa.fused_flash_bias_recommended(1025)


def test_convert_carries_the_position_bias_at_window_1025():
    """The (2 * 1025 + 1, H) tables of every block go across by name
    (``pos_bias/bias``), as the production model's checkpoints would."""
    from recommendations_tpu.nn.transformer import TransformerStack as JaxStack

    kw = dict(attn_type="multi_query", is_causal=True, use_bias=False, pos_bias_window=1025, use_flash=True)
    jm = JaxStack(num_layers=2, n_embd=32, n_head=4, **kw)
    vs = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 32))))
    rs = np.random.RandomState(2)
    for depth in range(2):
        attn = vs["params"][f"block_{depth}"]["attn"]
        attn["pos_bias"]["bias"] = rs.randn(2051, 4).astype(np.float32)
    tm = ttr.TransformerStack(2, 32, 4, torch.Generator().manual_seed(0), **kw)
    tm.load_state_dict(state_dict_from_jax(vs, tm))
    for depth in range(2):
        got = getattr(tm, f"block_{depth}").attn.pos_bias.bias
        assert got.shape == (2051, 4)
        np.testing.assert_array_equal(got.detach().numpy(), vs["params"][f"block_{depth}"]["attn"]["pos_bias"]["bias"])


def tiny_production_config(context=CONTEXT, compute_dtype="float32") -> dict:
    """lthm.yaml's shape at ``context`` (767 by default), cut to 2 narrow
    layers and small tables."""
    d = production_config(context)
    d.update(compute_dtype=compute_dtype, fused_ce=False, train_mini_batch_size=-1)
    d["log_q_config"]["num_buckets"] = 4096
    t = d["transformer_config"]
    t["num_layers"] = 2
    t["attn_config"].update(n_embd=32, n_head=4)
    pt = d["product_tower"]
    pt.update(inp_emb_dim=8, out_emb_dim=32, item_emb_dim=16, norm_bins=8,
              cosine_lsh_config=[{"num_bins": 4, "num_proj": 8}, {"num_bins": 8, "num_proj": 8}])
    pt["latent_model_config"]["vocab_size_latent"] = 5000
    return d


def tiny_batch(b=2, s=CONTEXT + 8, seed=0):
    """Right-padded histories (pad id 0), as chip_smoke.py builds requests."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(-(2**62), 2**62, size=(b, s)).astype(np.int64)
    ids[:, -4:] = 0
    ids[1, 600:] = 0
    return {
        "product_ids": ids,
        "labels": rs.randint(0, 4, size=(b, s)).astype(np.float32),
        "timestamps": rs.randint(1_600_000_000, 1_700_000_000, size=(b, s)).astype(np.float32),
    }


_PAIR = {}


def _pair():
    """(JAX wrapper, variables, port wrapper with the same weights), built once;
    the position-bias tables (zeros at init) get random values."""
    if not _PAIR:
        d = tiny_production_config()
        jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
        vs = jw.init_variables(jax.random.PRNGKey(0), {k: jnp.asarray(v[:, :40]) for k, v in tiny_batch().items()})
        vs = jax.tree_util.tree_map(np.asarray, vs)
        rs = np.random.RandomState(11)
        for depth in range(2):
            attn = vs["params"]["query_tower"]["transformer"][f"block_{depth}"]["attn"]
            attn["pos_bias"]["bias"] = rs.randn(*attn["pos_bias"]["bias"].shape).astype(np.float32)
        tw = LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
        tw.load_jax_variables(vs)
        _PAIR.update(jw=jw, vs=vs, tw=tw)
    return _PAIR["jw"], _PAIR["vs"], _PAIR["tw"]


def test_tiny_production_model_serves_as_jax(monkeypatch):
    jw, vs, tw = _pair()
    batch = tiny_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    calls = []
    real = tfa.fused_flash_attention_bias_fwd
    monkeypatch.setattr(tfa, "fused_flash_attention_bias_fwd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = tw.inference_models()["sequence_encoder"](batch)
    monkeypatch.undo()
    assert len(calls) == 2  # one bias forward per layer
    want = jw.forward(vs, jbatch)
    assert got["next_token_emb"].shape == (2, CONTEXT + 1, 6, 16)
    np.testing.assert_allclose(got["next_token_emb"].numpy(), np.asarray(want["next_token_emb"]),
                               rtol=0, atol=1e-4)
    ju = jw.inference_models()["user_encoder"](vs, jbatch)["user_emb"]
    tu = tw.inference_models()["user_encoder"](batch)["user_emb"]
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-5)


def test_tiny_production_training_step_matches_jax():
    """One training loss and its gradients (remat on, dots_no_batch, in both
    packages), the position-bias tables' included."""
    jw, vs, tw = _pair()
    batch = tiny_batch(seed=1)
    rng = jax.random.PRNGKey(3)
    offsets = np.asarray(sample_offsets(jax.random.split(rng)[1], jw.config.lookahead))

    def loss_fn(p):
        return jw.loss_and_metrics(p, vs["constants"], jw.init_aux_state(),
                                   {k: jnp.asarray(v) for k, v in batch.items()}, rng, True)

    (jl, _), jg = jax.value_and_grad(loss_fn, has_aux=True)(vs["params"])
    tw.module.zero_grad(set_to_none=True)
    tl, _, _ = tw.loss_and_metrics(batch, tw.init_aux_state(), True, offsets=offsets)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= 1e-4
    want = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jg), "constants": vs["constants"]}, tw.module
    )
    checked = 0
    for name, p in tw.module.named_parameters():
        if name.startswith("product_emb_module."):
            assert p.grad is None
            continue
        w = want[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= (2**-8 if ".direction_emb_" in name else 2e-4), f"{name}: {err:.3e}"
        checked += name.endswith("pos_bias.bias")
    assert checked == 2


def _stack_grads(policy, remat, t=40, window=None, bias=True):
    """Gradients of one small causal MQA stack with a position bias (the
    fused bias path when window covers t >= BIAS_MIN_SEQ, _sdpa below), or
    without one (the flash path)."""
    window = (window or t) if bias else None
    torch.manual_seed(0)
    stack = ttr.TransformerStack(2, 32, 4, torch.Generator().manual_seed(1), remat=remat,
                                 remat_policy=policy, attn_type="multi_query", is_causal=True,
                                 use_bias=False, pos_bias_window=window, use_flash=True)
    with torch.no_grad():
        for depth in range(2 if bias else 0):
            getattr(stack, f"block_{depth}").attn.pos_bias.bias.normal_()
    x = torch.randn(2, t, 32, requires_grad=True)
    stack(x).square().sum().backward()
    return [x.grad] + [p.grad for p in stack.parameters()]


@pytest.mark.parametrize("policy", ["dots_no_batch", "dots", "full"])
@pytest.mark.parametrize("t", [40, 768])
def test_remat_gives_the_same_gradients_bit_for_bit(policy, t):
    plain = _stack_grads(policy, False, t)
    remat = _stack_grads(policy, True, t)
    assert len(plain) == len(remat)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy,runs", [("dots_no_batch", 2), ("dots", 2), ("full", 4)])
def test_remat_policy_keeps_the_bias_forward(monkeypatch, policy, runs):
    """dots_no_batch and dots keep the bias forward's (o, lse): the backward
    does not run it again (on the card, 16 rather than 32 launches a step of
    the 16-layer model); full recomputes it. Serving never recomputes."""
    calls = []
    real = tfa.fused_flash_attention_bias_fwd
    monkeypatch.setattr(tfa, "fused_flash_attention_bias_fwd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _stack_grads(policy, True, 768)
    assert len(calls) == runs


@pytest.mark.parametrize("policy", ["dots_no_batch", "dots", "full"])
def test_remat_without_bias_gives_the_same_gradients_bit_for_bit(policy):
    plain = _stack_grads(policy, False, bias=False)
    remat = _stack_grads(policy, True, bias=False)
    assert len(plain) == len(remat)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy,runs", [("dots_no_batch", 2), ("dots", 2), ("full", 4)])
def test_remat_policy_keeps_the_flash_forward(monkeypatch, policy, runs):
    """As for the bias forward: dots_no_batch and dots keep the no-bias flash
    forward's (o, lse), as the JAX policies save flash_out and flash_lse;
    full recomputes it."""
    calls = []
    real = tfa.fused_flash_attention_fwd
    monkeypatch.setattr(tfa, "fused_flash_attention_fwd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _stack_grads(policy, True, bias=False)
    assert len(calls) == runs


SHORT_CONTEXT = 127  # T = 128 = the window, below BIAS_MIN_SEQ: _sdpa with the bias


def test_bf16_remat_step_through_sdpa_at_the_window_matches_jax(monkeypatch):
    """lthm.yaml's own regime, T = window < 768 (its context 512 gives T =
    513), at its bf16 compute with remat (dots_no_batch), cut to 2 layers
    (d=32, MQA with 4 heads) at T = 128: attention on the CPU takes _sdpa
    with the bias in both packages, recomputed in the backward. One training
    loss and its gradients against JAX, held as test_grads_match_jax_bf16
    (tests/test_torch_train.py) holds bf16: the loss within 1e-2, each
    gradient within 2**-4 norm-relative."""
    from recommendations_tpu_torch.nn import attention as tatt

    d = tiny_production_config(SHORT_CONTEXT, "bfloat16")
    assert d["transformer_config"]["attn_config"]["pos_bias"]["context_window"] == SHORT_CONTEXT + 1
    assert d["transformer_config"]["enable_gradient_checkpointing"]
    batch = tiny_batch(b=2, s=SHORT_CONTEXT + 8, seed=4)
    batch["product_ids"][1, 90:] = 0
    jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
    vs = jax.tree_util.tree_map(np.asarray, jw.init_variables(
        jax.random.PRNGKey(0), {k: jnp.asarray(v[:, :40]) for k, v in batch.items()}))
    rs = np.random.RandomState(12)
    for depth in range(2):
        attn = vs["params"]["query_tower"]["transformer"][f"block_{depth}"]["attn"]
        attn["pos_bias"]["bias"] = rs.randn(*attn["pos_bias"]["bias"].shape).astype(np.float32)
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
    tw.load_jax_variables(vs)
    rng = jax.random.PRNGKey(5)
    offsets = np.asarray(sample_offsets(jax.random.split(rng)[1], jw.config.lookahead))

    def loss_fn(p):
        return jw.loss_and_metrics(p, vs["constants"], jw.init_aux_state(),
                                   {k: jnp.asarray(v) for k, v in batch.items()}, rng, True)

    (jl, _), jg = jax.value_and_grad(loss_fn, has_aux=True)(vs["params"])
    seen = []
    real_sdpa = tatt._sdpa
    monkeypatch.setattr(tatt, "_sdpa", lambda q, *a: seen.append(q.shape[-2]) or real_sdpa(q, *a))
    tl, _, _ = tw.loss_and_metrics(batch, tw.init_aux_state(), True, offsets=offsets)
    tl.backward()
    assert seen == [SHORT_CONTEXT + 1] * 4  # 2 layers, each run again under remat
    assert abs(tl.item() - float(jl)) <= 1e-2
    want = state_dict_from_jax(
        {"params": jax.tree_util.tree_map(np.asarray, jg), "constants": vs["constants"]}, tw.module
    )
    checked = 0
    for name, p in tw.module.named_parameters():
        if name.startswith("product_emb_module."):
            assert p.grad is None
            continue
        w = want[name].numpy()
        err = np.linalg.norm(p.grad.float().numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 2**-4, f"{name}: {err:.3e}"
        checked += name.endswith("pos_bias.bias")
    assert checked == 2
