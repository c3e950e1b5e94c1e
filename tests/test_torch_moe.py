"""The port's MoE rotator and sparse-token keep-sets
(recommendations_tpu_torch.nn.transformer, models.lthm) against the JAX
package's, on the CPU, with the same weights: ``MoELinear`` in float32 and
bf16, with gate layers and top-k (experts tied at the k-th gate all kept),
the keep-sets' arrays, the sparse block (its one-token branch, with and
without the position bias, causal or not), the stack under remat, an LTHM
with both (forward, loss and one step's gradients), and ``rotator()`` for
every form of ``rotator_config`` the JAX config accepts."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.models.lthm import config as jcfg
from recommendations_tpu.models.lthm.loss import sample_offsets
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxWrapper
from recommendations_tpu.nn import transformer as jtr
from recommendations_tpu_torch.models.lthm import config as tcfg
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.nn import transformer as ttr

torch.set_num_threads(1)

F32_TOL = 2e-5   # float32 forwards (tests/test_fused_attention.py)
GRAD_TOL = 2e-4  # each gradient, norm-relative, float32
LSH_GRAD_TOL = 2**-8  # the cosine-LSH tables' bf16 product (tests/test_torch_train.py)
LOSS_TOL = 1e-4


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _load(module, variables):
    module.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables), module))
    return module


@pytest.fixture
def jax_bf16_products(monkeypatch):
    """XLA's CPU backend has no bf16 x bf16 -> float32 product, which
    ``MoELinear``'s expert einsums ask for (``preferred_element_type``).
    Their operands are cast to float32 first here: a bf16 value is exact in
    float32, so each product and its float32 sum are the ones asked for."""
    einsum = jnp.einsum

    def f32_operands(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o for o in ops]
        return einsum(spec, *ops, preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jnp, "einsum", f32_operands)


def _perturbed(vs):
    """Nonzero biases and LayerNorm scales (they start at 0 and 1), so a
    swapped or dropped one shows."""
    rs = np.random.RandomState(11)
    return jax.tree_util.tree_map(
        lambda a: a + 0.1 * rs.randn(*a.shape).astype(a.dtype) if a.ndim <= 2 and a.shape[-1] < 200 else a,
        jax.tree_util.tree_map(np.asarray, vs),
    )


# -- MoELinear ------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype,gate_sizes,top_k",
    [("float32", (), None), ("float32", (8, 6), 2), ("bfloat16", (), None), ("bfloat16", (8,), 2)],
)
def test_moe_linear_matches_jax(dtype, gate_sizes, top_k, jax_bf16_products):
    """float32 at 2e-5; bf16 as the LTHM's bf16 forward is held (2**-6 of
    the largest output): the packages round the Dense outputs at different
    points (JAX rounds the product, then the bias add; the port once), so a
    bf16 gate can differ by an ulp. With top-k that can tie the k-th gate
    in one package and not in the other, which keeps another set of
    experts: such rows are counted (each must have more than k experts kept
    in one package, at most 10% of the rows) and the other rows held."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = np.random.RandomState(1).randn(3, 7, 12).astype(np.float32)
    jm = jtr.MoELinear(out_features=10, proj_features=6, num_experts=4, top_k=top_k,
                       gate_sizes=gate_sizes, dtype=jdt)
    vs = _perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(x, jdt)))
    want, inter = jm.apply(vs, jnp.asarray(x, jdt), capture_intermediates=True)
    want = np.asarray(want.astype(jnp.float32))
    tm = _load(ttr.MoELinear(12, 10, 6, 4, _gen(), top_k=top_k, gate_sizes=gate_sizes, dtype=tdt), vs)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(tdt))
        kept = (tm.gates(torch.from_numpy(x).to(tdt)) > 0).numpy()
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
        return
    same = np.ones(want.shape[:-1], bool)
    if top_k is not None:
        # JAX's own kept sets, from its gate_out output as MoELinear forms them
        g = inter["intermediates"]["gate_out"]["__call__"][0]
        g = g / jnp.sqrt(jnp.asarray(12, jnp.float32)).astype(g.dtype)
        j_kept = np.asarray(g >= jax.lax.top_k(g, top_k)[0][..., -1:])
        same = (kept == j_kept).all(-1)
        assert ((kept.sum(-1) > top_k) | (j_kept.sum(-1) > top_k))[~same].all()
        assert (~same).sum() <= 0.1 * same.size
    assert np.abs(got - want)[same].max() <= 2**-6 * np.abs(want).max()


def test_moe_top_k_keeps_every_expert_tied_at_the_kth_gate():
    """Experts 1 and 2 have the same gate weights, so their gates tie on
    every row; with top_k = 1 and them on top both stay (JAX masks by the
    k-th value, not by index), which a top-k of exactly k indices would
    not give."""
    x = np.random.RandomState(3).randn(2, 5, 8).astype(np.float32)
    jm = jtr.MoELinear(out_features=8, proj_features=4, num_experts=4, top_k=1)
    vs = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    vs = copy.deepcopy(vs)
    gate = vs["params"]["gate_out"]
    gate["kernel"][:, 2] = gate["kernel"][:, 1]
    gate["bias"][:] = [0.0, 10.0, 10.0, 0.0]  # experts 1 and 2 lead on every row
    want = np.asarray(jm.apply(vs, jnp.asarray(x)))
    tm = _load(ttr.MoELinear(8, 8, 4, 4, _gen(), top_k=1), vs)
    with torch.no_grad():
        gates = tm.gates(torch.from_numpy(x))
        got = tm(torch.from_numpy(x))
    kept = (gates > 0).sum(-1)
    assert int(kept.min()) >= 2, "a tie at the k-th gate kept fewer experts than are tied"
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_moe_init_counts_the_expert_axis_in_the_fan_in():
    """flax's lecun_normal on the (E, in, proj) stack: variance 1 / (E * in),
    truncated at two standard deviations."""
    m = ttr.MoELinear(64, 32, 128, 8, _gen(5))
    w = m.w1.detach()
    std = np.sqrt(1.0 / (8 * 64))
    assert abs(w.std().item() - std) < 0.03 * std
    assert w.abs().max().item() <= 2.0 * std / 0.87962566103423978 + 1e-7


# -- the sparse keep-sets ---------------------------------------------------------


@pytest.mark.parametrize("size,factor,seed,n_cls", [(25, 0.5, 0, 1), (1025, 0.5, 3, 1), (40, 0.3, 7, 0)])
def test_sparse_keep_sets_equal_jax(size, factor, seed, n_cls):
    want = jtr._sparse_keep_sets(size, factor, seed, n_cls)
    got = ttr._sparse_keep_sets(size, factor, seed, n_cls)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize(
    "t,max_block,factor,window,causal,use_flash",
    [
        (24, 24, 0.5, None, True, True),    # the flash path over the kept tokens
        (24, 24, 0.5, None, False, False),  # _sdpa, not causal
        (20, 32, 0.5, 40, True, True),      # the position bias (nk = T' on _sdpa); idx filtered to < T
        (16, 16, 0.1, None, True, False),   # one kept token: x + null_connector(x)
    ],
)
def test_sparse_block_matches_jax(t, max_block, factor, window, causal, use_flash):
    x = np.random.RandomState(t).randn(2, t, 32).astype(np.float32)
    kw = dict(attn_type="multi_query", is_causal=causal, use_bias=True, pos_bias_window=window, rotator=2.0,
              is_sparse_attn=True, max_block_size=max_block, sparsity_factor=factor, n_cls=1, use_flash=use_flash)
    jm = jtr.TransformerBlock(n_embd=32, n_head=4, sparse_seed=3, **kw)
    vs = _perturbed(jm.init(jax.random.PRNGKey(6), jnp.asarray(x)))
    if window is not None:  # the bias table starts at zeros
        b = vs["params"]["attn"]["pos_bias"]["bias"]
        vs["params"]["attn"]["pos_bias"]["bias"] = np.random.RandomState(8).randn(*b.shape).astype(np.float32)
    want = np.asarray(jm.apply(vs, jnp.asarray(x)))
    tm = ttr.TransformerBlock(32, 4, _gen(), sparse_seed=3, **kw)
    if set(vs["params"]) == {"null_connector"}:  # JAX made no attention or MLP for one kept token
        _load(tm.null_connector, {"params": vs["params"]["null_connector"]})
    else:
        _load(tm, vs)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    idx, not_idx = (a[a < t] for a in ttr._sparse_keep_sets(max_block, factor, 3, 1))
    with torch.no_grad():
        xs = torch.from_numpy(x)[:, not_idx]
        skipped = (xs + tm.null_connector(xs)).numpy()
    np.testing.assert_array_equal(got[:, not_idx], skipped)  # the skipped rows: x + null(x)
    if len(idx) <= 1:  # no attention at all: every row x + null(x)
        with torch.no_grad():
            xt = torch.from_numpy(x)
            np.testing.assert_array_equal(got, (xt + tm.null_connector(xt)).numpy())


def test_sparse_block_needs_max_block_size_as_jax():
    x = jnp.zeros((1, 4, 8))
    with pytest.raises(AssertionError):
        jtr.TransformerBlock(n_embd=8, n_head=2, is_sparse_attn=True).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="max_block_size"):
        ttr.TransformerBlock(8, 2, _gen(), is_sparse_attn=True)


def test_sparse_moe_stack_under_remat_matches_jax():
    """Two sparse MoE blocks (block i seeded with i) under remat: the port's
    gradients equal its own without remat bit for bit (the recomputation
    gathers the same positions) and JAX's remat stack's within 2e-4. The
    port takes the flash route, JAX its XLA attention (the same function at
    float32; the Pallas kernel in interpret mode is slow here)."""
    t, c = 18, 16
    x = np.random.RandomState(9).randn(2, t, c).astype(np.float32)
    spec = dict(num_experts=3, proj_features=8, ff_mult_factor=2.0, gate_sizes=(6,), top_k=2)
    kw = dict(attn_type="multi_query", is_causal=True, use_bias=True, is_sparse_attn=True, max_block_size=t,
              sparsity_factor=0.6, n_cls=1)
    jm = jtr.TransformerStack(num_layers=2, n_embd=c, n_head=2, rotator=jtr.MoESpec(**spec), remat=True,
                              use_flash=False, **kw)
    vs = _perturbed(jm.init(jax.random.PRNGKey(10), jnp.asarray(x)))
    g = np.random.RandomState(12).randn(2, t, c).astype(np.float32)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * g)))(vs["params"])
    tm = _load(ttr.TransformerStack(2, c, 2, _gen(), remat=True, rotator=ttr.MoESpec(**spec), use_flash=True,
                                    **kw), vs)
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrad)}, tm)
    grads = {}
    for remat in (True, False):
        tm.remat = remat
        tm.zero_grad(set_to_none=True)
        (tm(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
        grads[remat] = {n: p.grad.clone() for n, p in tm.named_parameters()}
    assert any("moe_fc.w1" in n for n in grads[True]) and any("null_connector" in n for n in grads[True])
    for n, p in grads[True].items():
        assert torch.equal(p, grads[False][n]), n
        err = np.linalg.norm(p.numpy() - want[n].numpy()) / max(np.linalg.norm(want[n].numpy()), 1e-30)
        assert err <= GRAD_TOL, f"{n}: {err:.3e}"


# -- an LTHM with both ---------------------------------------------------------


def moe_sparse_config(use_flash, pos_bias, compute_dtype="float32"):
    """2 layers, d=32, MQA with 4 heads, context 24 (T = 25 with the CLS),
    the MoE rotator (gate layer, top-2 of 3) and keep-sets of 0.6."""
    attn = dict(n_head=4, n_embd=32, attn_type="multi_query", dropout=0.0, attn_dropout=0.0, bias=True)
    if pos_bias:
        attn["pos_bias"] = {"context_window": 25}
    return dict(
        features={"defaults": {}},
        compute_dtype=compute_dtype,
        transformer_config=dict(
            rotator_config={"moe": {"num_experts": 3, "proj_features": 8, "ff_mult_factor": 2,
                                    "gate_sizes": [6], "top_k": 2}},
            is_causal=True, num_layers=2, use_flash_attention=use_flash,
            is_sparse_attn=True, max_block_size=25, sparsity_factor=0.6,
            attn_config=attn,
        ),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=32, product_emb_dim=16, norm_bins=8,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 16}],
            latent_model_config={"vocab_size_latent": 5000, "num_shifts_latent": 4, "normalize_embedding": True},
        ),
        log_q_config={"num_buckets": 64, "hash_offsets": [0, 7]},
        lookahead=[0, 2, 4],
        context_width=24,
        table_optimizer="frozen",
    )


def _jax_side(d):
    """The JAX config of ``d`` on its XLA attention."""
    d = copy.deepcopy(d)
    d["transformer_config"]["use_flash_attention"] = False
    return d


def small_batch(b=4, s=30, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(-(2**62), 2**62, size=(b, s)).astype(np.int64)
    ids[:, -3:] = 0
    ids[1, 20:] = 0
    return {
        "product_ids": ids,
        "labels": rs.randint(0, 4, size=(b, s)).astype(np.float32),
        "timestamps": rs.randint(1_600_000_000, 1_700_000_000, size=(b, s)).astype(np.float32),
    }


@pytest.mark.parametrize("use_flash,pos_bias", [(True, False), (False, True)])
def test_moe_sparse_lthm_matches_jax(use_flash, pos_bias):
    """Forward at 2e-5, the loss at 1e-4, every gradient at 5e-4
    norm-relative (the LSH tables at one bf16 ulp), the position-bias tables
    random. The experts' sums run in another order than JAX's: the forward
    agrees to 3e-7 relative, but the loss stores its logits in bf16 in both
    packages (models/lthm/loss.py), so a last-bit difference can move a few
    logits by a bf16 step, and the loss (4.4e-5 on 22.8) and the gradients
    (4.5e-4 at worst, with the random tables) move with them; with the MLP
    rotator in the same model they agree to 1e-6. With ``use_flash`` the
    port takes its flash route and JAX its XLA attention (the Pallas kernel
    in interpret mode is slow here)."""
    d = moe_sparse_config(use_flash, pos_bias)
    jw = JaxWrapper(jcfg.LTHMModelConfig(**_jax_side(d)))
    batch = small_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    vs = jax.tree_util.tree_map(np.asarray, jw.init_variables(jax.random.PRNGKey(0), jbatch))
    if pos_bias:
        for i in range(2):
            tb = vs["params"]["query_tower"]["transformer"][f"block_{i}"]["attn"]["pos_bias"]
            tb["bias"] = np.random.RandomState(20 + i).randn(*tb["bias"].shape).astype(np.float32)
    tw = LTHMModelWrapper(tcfg.LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
    tw.load_jax_variables(vs)
    assert isinstance(tw.module.query_tower.transformer.block_0.moe_fc, ttr.MoELinear)
    want = jw.forward(vs, jbatch)["next_token_emb"]
    got = tw.forward(batch)["next_token_emb"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)

    rng = jax.random.PRNGKey(3)
    offsets = np.asarray(sample_offsets(jax.random.split(rng)[1], d["lookahead"]))

    def loss_fn(p):
        return jw.loss_and_metrics(p, vs["constants"], jw.init_aux_state(), jbatch, rng, True)

    (jl, _), jg = jax.value_and_grad(loss_fn, has_aux=True)(vs["params"])
    tl, _, _ = tw.loss_and_metrics(batch, tw.init_aux_state(), True, offsets=offsets)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= LOSS_TOL
    want_g = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jg),
                                  "constants": vs["constants"]}, tw.module)
    checked = 0
    for name, p in tw.module.named_parameters():
        if name.startswith("product_emb_module."):
            continue
        tol = LSH_GRAD_TOL if ".direction_emb_" in name else 5e-4
        w = want_g[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= tol, f"{name}: {err:.3e}"
        checked += ("moe_" in name) + ("null_connector" in name)
    assert checked >= 2 * (2 * 8 + 2)


def test_moe_sparse_lthm_bf16_forward_matches_jax(jax_bf16_products):
    """bf16 compute, held as tests/test_torch_lthm.py holds the bf16 LTHM:
    every element within 2**-6 of the largest output, the mean error within
    2**-8 of the mean magnitude."""
    d = moe_sparse_config(True, False, "bfloat16")
    jw = JaxWrapper(jcfg.LTHMModelConfig(**_jax_side(d)))
    batch = small_batch(seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    vs = jax.tree_util.tree_map(np.asarray, jw.init_variables(jax.random.PRNGKey(1), jbatch))
    tw = LTHMModelWrapper(tcfg.LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
    tw.load_jax_variables(vs)
    w = np.asarray(jw.forward(vs, jbatch)["next_token_emb"]).astype(np.float32)
    g = tw.forward(batch)["next_token_emb"].float().numpy()
    assert np.abs(g - w).max() <= 2**-6 * np.abs(w).max()
    assert np.abs(g - w).mean() <= 2**-8 * np.abs(w).mean()


# -- rotator() -------------------------------------------------------------------

MOE = {"num_experts": 4, "proj_features": 8, "ff_mult_factor": 1.5, "gate_sizes": [6, 5], "top_k": 2}


@pytest.mark.parametrize("form", ["float", "ff_mult", "flat_moe", "nested_moe", "moe_config", "mlp_config", "other"])
def test_rotator_forms_match_jax(form):
    def make(mod):
        return {
            "float": 3,
            "ff_mult": {"ff_mult": 2},
            "flat_moe": dict(MOE),
            "nested_moe": {"moe": {k: v for k, v in MOE.items() if k != "gate_sizes"}},
            "moe_config": mod.MoEConfig(**MOE),
            "mlp_config": mod.MLPConfig(ff_mult=1.5),
            "other": {"something": 1},
        }[form]

    attn = {"n_head": 2, "n_embd": 8}
    want = jcfg.TransformerConfig(rotator_config=make(jcfg), attn_config=attn).rotator()
    got = tcfg.TransformerConfig.from_dict({"rotator_config": make(tcfg), "attn_config": attn}).rotator()
    if isinstance(want, jtr.MoESpec):
        assert isinstance(got, ttr.MoESpec) and dataclasses.asdict(got) == dataclasses.asdict(want)
    else:
        assert isinstance(got, float) and got == want
