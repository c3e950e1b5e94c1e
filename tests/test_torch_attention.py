"""Port attention (recommendations_tpu_torch.nn.attention, .nn.transformer,
.ops.fused_attention) against the JAX package's, on the CPU.

The flash kernel's plain version is held to the Pallas kernel run in
interpret mode (o and the logsumexp), at the JAX kernel tests' float32
tolerance; the layers are held to their JAX counterparts with the same
weights on both the flash and the ``_sdpa`` paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.nn import attention as jatt
from recommendations_tpu.nn import transformer as jtr
from recommendations_tpu.ops import fused_attention as jfa
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.nn import attention as tatt
from recommendations_tpu_torch.nn import transformer as ttr
from recommendations_tpu_torch.ops import fused_attention as tfa

torch.set_num_threads(1)

F32_TOL = 2e-5  # as tests/test_fused_attention.py's forward checks


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _load(module, variables):
    module.load_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables), module)
    )
    return module


def _qkv(b, t, n_head, hd, kvh, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, t, n_head * hd).astype(np.float32)
    k = rs.randn(b, t, kvh * hd).astype(np.float32)
    v = rs.randn(b, t, kvh * hd).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "t,tile,n_head,kvh,causal",
    [
        (96, 32, 4, 1, True),
        (96, 32, 4, 1, False),
        (96, 32, 4, 4, True),
        (96, 32, 4, 4, False),
        (70, 32, 2, 1, True),
        (70, 32, 4, 4, True),
        (70, None, 4, 1, False),
    ],
)
def test_flash_plain_version_matches_pallas_kernel(t, tile, n_head, kvh, causal):
    b, hd = 2, 16
    q, k, v = _qkv(b, t, n_head, hd, kvh, seed=t + n_head + kvh)
    o_pad, lse_pad, _ = jfa._fused_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_head, causal, tile, True
    )
    want_o = np.asarray(o_pad)[:, :t, : n_head * hd]
    want_lse = np.asarray(lse_pad)[:, :t, :n_head]
    got_o, got_lse = tfa.fused_flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), n_head, causal
    )
    assert got_o.dtype == torch.float32 and got_lse.shape == (b, t, n_head)
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=F32_TOL, atol=F32_TOL)
    # the public entry point agrees with the dense oracle of the JAX tests
    got = tfa.fused_flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), n_head, causal
    )
    want = jfa.fused_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_head, causal, tile, True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_flash_plain_version_bf16_operands():
    """bf16 operands: q rounds after scaling, p rounds before the PV product;
    the output is bf16, so the two agree to a bf16 ulp."""
    b, t, n_head, hd = 2, 40, 4, 16
    q, k, v = _qkv(b, t, n_head, hd, 1, seed=9)
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    o_pad, lse_pad, _ = jfa._fused_fwd_impl(qb, kb, vb, n_head, True, None, True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got_o, got_lse = tfa.fused_flash_attention_fwd(tq, tk, tv, n_head, True)
    assert got_o.dtype == torch.bfloat16
    want_o = np.asarray(o_pad)[:, :t, : n_head * hd].astype(np.float32)
    np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=2**-8, atol=2**-8)
    np.testing.assert_allclose(
        got_lse.numpy(), np.asarray(lse_pad)[:, :t, :n_head], rtol=F32_TOL, atol=F32_TOL
    )


@pytest.mark.parametrize("exp2", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [96, 70])
def test_flash_plain_version_in_chunks_matches_pallas_kernel(t, causal, exp2):
    """The online softmax over 32-key chunks (the running max raised chunk by
    chunk, earlier sums rescaled), with exp or exp2, against the Pallas
    kernel in interpret mode: the same function up to f32 rounding."""
    b, n_head, hd = 2, 4, 16
    q, k, v = _qkv(b, t, n_head, hd, 1, seed=t + 11)
    o_pad, lse_pad, _ = jfa._fused_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), n_head, causal, 32, True)
    got_o, got_lse = tfa.fused_flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), n_head, causal, chunk=32, exp2=exp2
    )
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o_pad)[:, :t, : n_head * hd], rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse_pad)[:, :t, :n_head], rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("t,causal", [(96, True), (70, True), (70, False)])
def test_flash_plain_version_at_the_kernel_chunk_bf16(t, causal):
    """bf16 operands at the tensor-core kernel's arithmetic (16-key chunks,
    exp2): p rounds to bf16 against a running max rather than the row's, so
    o agrees with the Pallas kernel to a bf16 ulp, lse to f32 rounding."""
    b, n_head, hd = 2, 16, 16
    q, k, v = _qkv(b, t, n_head, hd, 1, seed=t + 12)
    qb, kb, vb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    o_pad, lse_pad, _ = jfa._fused_fwd_impl(qb, kb, vb, n_head, causal, 32, True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    arith = tfa.kernel_softmax(tq, tk, n_head)
    assert arith == {"chunk": tfa.KERNEL_SOFTMAX_CHUNK, "exp2": True}
    got_o, got_lse = tfa.fused_flash_attention_reference(tq, tk, tv, n_head, causal, **arith)
    want_o = np.asarray(o_pad)[:, :t, : n_head * hd].astype(np.float32)
    np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=2**-8, atol=2**-8)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse_pad)[:, :t, :n_head], rtol=F32_TOL, atol=F32_TOL)


def test_flash_wrapper_rejects_bad_inputs_and_counts_no_cpu_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 2, 16, 1, seed=1))
    before = tfa.FLASH_FWD.launches
    tfa.fused_flash_attention(q, k, v, 2, True)
    assert tfa.FLASH_FWD.launches == before  # the plain version launched nothing
    with pytest.raises(TypeError):
        tfa.fused_flash_attention(q.double(), k.double(), v.double(), 2, True)
    with pytest.raises(TypeError):
        tfa.fused_flash_attention(q.half(), k.half(), v.half(), 2, True)
    with pytest.raises(ValueError):
        tfa.fused_flash_attention(q, k[:, :4], v[:, :4], 2, True)
    with pytest.raises(ValueError):
        tfa.fused_flash_attention(q, k[..., :8], v[..., :8], 2, True)


def _attn_pair(kind, n_embd, n_head, use_flash, pos_bias_window, dtype, x, causal):
    jcls = jatt.MultiQueryAttention if kind == "mqa" else jatt.MultiHeadAttention
    tcls = tatt.MultiQueryAttention if kind == "mqa" else tatt.MultiHeadAttention
    jdt = None if dtype is None else jnp.bfloat16
    tdt = None if dtype is None else torch.bfloat16
    jm = jcls(n_embd=n_embd, n_head=n_head, use_bias=True, use_flash=use_flash,
              pos_bias_window=pos_bias_window, dtype=jdt)
    vs = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x), causal=causal))
    if pos_bias_window is not None:  # a nonzero bias table, so the bias counts
        table = vs["params"]["pos_bias"]["bias"]
        vs["params"]["pos_bias"]["bias"] = np.random.RandomState(1).randn(*table.shape).astype(np.float32)
    tm = _load(tcls(n_embd, n_head, _gen(), use_bias=True, use_flash=use_flash,
                    pos_bias_window=pos_bias_window, dtype=tdt), vs)
    want = jm.apply(vs, jnp.asarray(x), deterministic=True, causal=causal)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), causal=causal)
    return np.asarray(want).astype(np.float32), got.float().numpy()


@pytest.mark.parametrize("kind", ["mqa", "mha"])
@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_layers_f32(kind, use_flash, causal):
    x = np.random.RandomState(3).randn(2, 37, 32).astype(np.float32)
    want, got = _attn_pair(kind, 32, 4, use_flash, None, None, x, causal)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["mqa", "mha"])
def test_attention_position_bias_sdpa_path(kind):
    """pos_bias below BIAS_MIN_SEQ: both packages take _sdpa with the bias."""
    x = np.random.RandomState(4).randn(2, 21, 32).astype(np.float32)
    want, got = _attn_pair(kind, 32, 4, True, 24, None, x, True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_flash", [True, False])
def test_attention_layer_bf16(use_flash):
    """bf16 compute: projections and outputs round to bf16 in both packages
    (at possibly different points of a fused op), so they agree to a few
    bf16 ulps of the output's scale."""
    x = np.random.RandomState(5).randn(2, 37, 64).astype(np.float32)
    want, got = _attn_pair("mqa", 64, 4, use_flash, None, "bf16", x, True)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2**-8 * scale)


def test_sdpa_bf16_gradients_match_jax():
    """bf16 _sdpa (MQA 32x16, causal, T = 257) differentiated against JAX's
    _sdpa VJP on the same inputs: the softmax shift carries no gradient in
    either (JAX's stop_gradient), so dq, dk and dv agree to 2^-8 of the
    largest element. Through an undetached max the bf16 cotangents no longer
    cancel and the row sums land on each row's argmax logit."""
    b, t, h, hd = 2, 257, 32, 16
    rs = np.random.RandomState(21)
    q, dy = (rs.randn(b, h, t, hd).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, 1, t, hd).astype(np.float32) for _ in range(2))
    jq, jk, jv, jdy = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, dy))
    jmask = jatt.causal_mask(t)
    _, vjp = jax.vjp(lambda a, bb, c: jatt._sdpa(a, bb, c, jmask, None), jq, jk, jv)
    want = [np.asarray(g).astype(np.float32) for g in vjp(jdy)]
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    out = tatt._sdpa(tq, tk, tv, tatt.causal_mask(t), None)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dy).bfloat16())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        tol = 2**-8 * np.abs(w).max()
        err = np.abs(g.float().numpy() - w).max()
        assert err <= tol, f"{name}: max|err| {err} over tol {tol}"


@pytest.mark.parametrize("case", ["mask", "window", "bias_range", "fused"])
def test_flash_fallback_warns_once_per_reason_as_jax(case, caplog, monkeypatch):
    """use_flash asked for but attention falls back to _sdpa: both packages
    log one warning naming the reason (an explicit mask; T over the window;
    T outside the bias kernel's range), once however often the layer runs;
    the fused path logs nothing."""
    monkeypatch.setattr(jatt, "_warned", set())
    monkeypatch.setattr(tatt, "_warned", set())
    t = 21
    window = {"window": 16, "bias_range": 24}.get(case)
    x = np.random.RandomState(13).randn(1, t, 32).astype(np.float32)
    mask = tatt.causal_mask(t) if case == "mask" else None
    jm = jatt.MultiQueryAttention(n_embd=32, n_head=4, use_flash=True, pos_bias_window=window)
    jmask = None if mask is None else jnp.asarray(mask.numpy())
    tm = tatt.MultiQueryAttention(32, 4, _gen(), use_flash=True, pos_bias_window=window)
    messages = {}
    for pkg, run in (
        ("jax", lambda: jm.init_with_output(jax.random.PRNGKey(0), jnp.asarray(x), mask=jmask, causal=True)),
        ("torch", lambda: tm(torch.from_numpy(x), mask=mask, causal=True)),
    ):
        caplog.clear()
        with caplog.at_level("WARNING"):
            for _ in range(2):
                try:
                    with torch.no_grad():
                        run()
                except ValueError:  # T over the window: the bias table cannot cover it
                    pass
        messages[pkg] = [r.getMessage() for r in caplog.records if "use_flash requested" in r.getMessage()]
    assert messages["torch"] == messages["jax"]
    want = {"mask": "an explicit additive mask", "window": "exceeds the pos-bias window 16",
            "bias_range": "outside the fused pos-bias kernel's winning range", "fused": None}[case]
    if want is None:
        assert messages["torch"] == []
    else:
        assert len(messages["torch"]) == 1 and want in messages["torch"][0]


def test_fused_bias_kernel_taken_at_t_eq_window(monkeypatch):
    """The fused bias path (T = 768 = the window) is taken and agrees with
    _sdpa on the same weights at a bf16-representable table (the kernel
    applies the table at bf16). (At T below the window the two paths read
    different table rows, in the JAX package as here: _sdpa indexes
    q - k + T, the fused path q - k + window.)"""
    x = torch.from_numpy(np.random.RandomState(8).randn(1, 768, 32).astype(np.float32))
    m = tatt.MultiQueryAttention(32, 4, _gen(), use_flash=True, pos_bias_window=768)
    with torch.no_grad():
        m.pos_bias.bias.copy_(torch.randn(m.pos_bias.bias.shape, generator=_gen(2)).bfloat16().float())
    sdpa_path = tatt.MultiQueryAttention(32, 4, _gen(), use_flash=False, pos_bias_window=768)
    sdpa_path.load_state_dict(m.state_dict())
    calls = []
    monkeypatch.setattr(tfa, "fused_flash_attention_bias",
                        lambda *a, **kw: calls.append(1) or tfa.fused_flash_attention_bias_fwd(*a, **kw)[0])
    with torch.no_grad():
        got, want = m(x, causal=True), sdpa_path(x, causal=True)
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_causal_mask_and_dispatch_knobs():
    np.testing.assert_array_equal(tatt.causal_mask(5).numpy(), np.asarray(jatt.causal_mask(5)))
    assert tfa.RECOMMENDED_MAX_SEQ == jfa.RECOMMENDED_MAX_SEQ
    assert tfa.BIAS_MIN_SEQ == jfa.BIAS_MIN_SEQ  # the CPU dispatch's value
    for t in (257, 767, 768, 4096, 4097):
        assert tfa.fused_flash_recommended(t) == jfa.fused_flash_recommended(t)
        assert tfa.fused_flash_bias_recommended(t) == jfa.fused_flash_bias_recommended(t)


# (T, window): (the fused bias kernels on a CPU tensor, on a CUDA tensor).
# The CPU column is the JAX package's dispatch; on a CUDA tensor the kernels
# also take every T == window.
BIAS_DISPATCH = {
    (2, 2): (False, True),
    (40, 40): (False, True),
    (65, 65): (False, True),
    (257, 257): (False, True),
    (256, 257): (False, False),   # a short request: _sdpa, as in JAX
    (513, 513): (False, True),    # lthm.yaml at its own context 512
    (512, 513): (False, False),
    (767, 767): (False, True),
    (767, 1025): (False, False),
    (768, 768): (True, True),     # BIAS_MIN_SEQ: JAX's range
    (768, 1025): (True, True),
    (1025, 1025): (True, True),   # production at context 1024
    (1026, 1025): (False, False),  # over the window
    (4097, 4097): (False, False),  # over RECOMMENDED_MAX_SEQ
}


@pytest.mark.parametrize("t,window", sorted(BIAS_DISPATCH))
def test_bias_dispatch_by_length_window_and_device(t, window):
    """Which path attention with a position bias takes, by (T, window,
    device); the CPU's is the JAX package's, and so is the layer's on a CPU
    tensor."""
    on_cpu, on_cuda = BIAS_DISPATCH[(t, window)]
    assert tfa.fused_flash_bias_taken(t, window, on_cuda=False) == on_cpu
    assert tfa.fused_flash_bias_taken(t, window, on_cuda=True) == on_cuda
    assert on_cpu == (t <= window and jfa.fused_flash_bias_recommended(t))
    m = tatt.MultiQueryAttention(32, 4, _gen(), use_flash=True, pos_bias_window=window)
    assert m._flash_bias_eligible(None, t, False) == on_cpu
    assert m._flash_bias_eligible(None, t, True) == on_cuda


@pytest.mark.parametrize("t", [33, 65, 129])
def test_fused_bias_plain_path_equals_jax_sdpa_at_the_window(t, monkeypatch):
    """At T = window below BIAS_MIN_SEQ, the path a CUDA tensor takes (the
    fused bias function; its plain version here, forced on the CPU) computes
    what JAX's _sdpa with the bias computes: f32 within 1e-5, at a table of
    bf16 values (the kernels apply the table at bf16)."""
    x = np.random.RandomState(t).randn(2, t, 32).astype(np.float32)
    jm = jatt.MultiQueryAttention(n_embd=32, n_head=4, use_bias=True, use_flash=True, pos_bias_window=t)
    vs = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x), causal=True))
    table = vs["params"]["pos_bias"]["bias"]
    vs["params"]["pos_bias"]["bias"] = (
        torch.randn(table.shape, generator=_gen(1)).bfloat16().float().numpy())
    want = np.asarray(jm.apply(vs, jnp.asarray(x), deterministic=True, causal=True))
    tm = _load(tatt.MultiQueryAttention(32, 4, _gen(), use_bias=True, use_flash=True, pos_bias_window=t), vs)
    calls = []
    monkeypatch.setattr(tfa, "BIAS_MIN_SEQ", 0)
    monkeypatch.setattr(tfa, "fused_flash_attention_bias",
                        lambda *a, **kw: calls.append(1) or tfa.fused_flash_attention_bias_fwd(*a, **kw)[0])
    with torch.no_grad():
        got = tm(torch.from_numpy(x), causal=True).numpy()
    assert calls == [1]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn_type", ["multi_query", "multi_head"])
@pytest.mark.parametrize("use_flash", [True, False])
def test_transformer_stack_f32(attn_type, use_flash):
    x = np.random.RandomState(6).randn(2, 33, 32).astype(np.float32)
    kw = dict(attn_type=attn_type, is_causal=True, use_bias=False, rotator=4.0, use_flash=use_flash)
    jm = jtr.TransformerStack(num_layers=2, n_embd=32, n_head=4, **kw)
    vs = jm.init(jax.random.PRNGKey(7), jnp.asarray(x))
    # non-trivial LayerNorm scales, so a swapped weight would show
    vs = jax.tree_util.tree_map(
        lambda a: a * 1.5 if a.ndim == 1 else a, jax.tree_util.tree_map(np.asarray, vs)
    )
    want = np.asarray(jm.apply(vs, jnp.asarray(x)))
    tm = _load(ttr.TransformerStack(2, 32, 4, _gen(), **kw), vs)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_transformer_unported_options_raise():
    with pytest.raises(ValueError, match="remat_policy"):
        ttr.TransformerStack(1, 32, 4, _gen(), remat=True, remat_policy="everything")
    with pytest.raises(NotImplementedError):
        ttr.TransformerBlock(32, 4, _gen(), rotator=object())
