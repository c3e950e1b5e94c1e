"""The port's flash attention with the relative-position bias
(recommendations_tpu_torch.ops.fused_attention.fused_flash_attention_bias)
against the JAX package's, on the CPU.

On the CPU the port runs the kernels' plain versions; the JAX side runs its
Pallas kernels (``_fwd_kernel_grid``, ``_dq_kernel_grid``,
``_dkv_kernel_grid`` with ``bias_mode``) in interpret mode, as
tests/test_fused_attention_bias.py does, with a small tile so that a short
sequence spans several tiles. The tables are not bf16 values, so both sides'
rounding of the table to bf16 shows. Tolerances are the JAX tests' own:
2e-5 for the forward, 3e-4 for the gradients, 5e-4 over several tiles
(tests/test_fused_attention_bias.py:93,129,159)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.nn import attention as jatt
from recommendations_tpu.ops import fused_attention as jfa
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.nn import attention as tatt
from recommendations_tpu_torch.ops import fused_attention as tfa

torch.set_num_threads(1)


def _inputs(b, t, n_head, hd, kvh, nk, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, t, n_head * hd).astype(np.float32)
    k = rs.randn(b, t, kvh * hd).astype(np.float32)
    v = rs.randn(b, t, kvh * hd).astype(np.float32)
    table = rs.randn(2 * nk + 1, n_head).astype(np.float32)
    do = rs.randn(b, t, n_head * hd).astype(np.float32)
    return q, k, v, table, do


BIAS_FWD_CASES = [
    (96, 4, 1, True, 32),
    (96, 4, 4, False, 32),
    (70, 2, 1, False, 32),  # T not a tile multiple
    (1025, 16, 1, True, 256),  # the production context, nk = T = 1025, at a narrow width (MQA 16x16)
]


@functools.lru_cache(maxsize=None)
def _pallas_bias_forward(t, n_head, kvh, causal, tile):
    """The inputs and the JAX Pallas bias forward (interpret mode) on them:
    (q, k, v, table, o, lse) as numpy arrays, B = 2, hd = 16, nk = T."""
    b, hd, nk = 2, 16, t
    q, k, v, table, _ = _inputs(b, t, n_head, hd, kvh, nk, seed=t + kvh)
    o, res = jfa._bias_fwd_shared(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table), n_head, nk, causal, tile, True
    )
    return q, k, v, table, np.asarray(o), np.asarray(res[4])[:, :t, :n_head]


@pytest.mark.parametrize("t,n_head,kvh,causal,tile", BIAS_FWD_CASES)
def test_bias_forward_matches_pallas_kernel(t, n_head, kvh, causal, tile):
    q, k, v, table, want_o, want_lse = _pallas_bias_forward(t, n_head, kvh, causal, tile)
    got_o, got_lse = tfa.fused_flash_attention_bias_fwd(
        *(torch.from_numpy(x) for x in (q, k, v, table)), n_head, t, causal
    )
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("t,n_head,kvh,causal,tile", BIAS_FWD_CASES)
def test_bias_forward_kernel_arithmetic_matches_pallas_kernel(t, n_head, kvh, causal, tile):
    """The plain bias forward in the one-pass tensor-core kernel's
    arithmetic (``chunk=16, exp2=True``: the running max rises once per
    16 keys, each exponential as 2**(x log2(e) - m log2(e))) against the
    Pallas grid kernel: f32 operands, so only the order of the f32 sums and
    the exp2 argument's rounding differ, within the same 2e-5."""
    q, k, v, table, want_o, want_lse = _pallas_bias_forward(t, n_head, kvh, causal, tile)
    got_o, got_lse = tfa.fused_flash_attention_bias_reference(
        *(torch.from_numpy(x) for x in (q, k, v, table)), n_head, t, causal, chunk=16, exp2=True
    )
    np.testing.assert_allclose(got_o.numpy(), want_o, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=2e-5, atol=2e-5)


def test_bias_kernel_softmax_names_each_kernels_arithmetic():
    """bf16 MQA with up to 8 groups of 16 heads and hd 16/32/64 takes the
    one-pass kernel (16-key chunks, exp2) and the tensor-core dQ kernel
    (exp2); more groups (up to 512 heads) the two-pass kernel, whose chunk is
    its staged tile (exp), and mqa_mma_dq_kernel (exp); the rest the FMA
    kernels (512 keys, exp). The no-bias forward's arithmetic is unchanged."""
    def arith(t, n_head, hd, kvh=1, dtype=torch.bfloat16, fn=tfa.bias_kernel_softmax):
        return fn(torch.zeros(1, t, n_head * hd, dtype=dtype), torch.zeros(1, t, kvh * hd, dtype=dtype), n_head)

    one_pass = {"chunk": 16, "exp2": True}
    for n_head, hd in ((16, 16), (32, 16), (48, 16), (64, 16), (128, 16), (32, 32), (128, 64)):
        assert arith(1025, n_head, hd) == one_pass, (n_head, hd)
    assert arith(300, 256, 16) == {"chunk": 64, "exp2": False}  # launch_mma's tile: 48 KB of stages
    assert arith(40, 256, 16) == {"chunk": 64, "exp2": False}
    assert arith(1025, 320, 16) == {"chunk": 32, "exp2": False}  # 20 groups: one row a block
    assert arith(1025, 32, 16, kvh=32) == {"chunk": 512, "exp2": False}  # MHA: the FMA kernel
    assert arith(1025, 32, 16, dtype=torch.float32) == {"chunk": 512, "exp2": False}
    assert arith(1025, 24, 16) == {"chunk": 512, "exp2": False}
    assert arith(1025, 32, 8) == {"chunk": 512, "exp2": False}
    assert arith(1025, 32, 16, fn=tfa.kernel_softmax) == one_pass


def test_bias_forward_bf16_operands():
    """bf16 operands: p rounds before the PV product and o to bf16 in both,
    so they agree to a bf16 ulp."""
    b, t, n_head, hd, nk = 2, 64, 4, 16, 64
    q, k, v, table, _ = _inputs(b, t, n_head, hd, 1, nk, seed=5)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jfa.fused_flash_attention_bias(jq, jk, jv, jnp.asarray(table), n_head, nk, True, 32, True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tfa.fused_flash_attention_bias(tq, tk, tv, torch.from_numpy(table), n_head, nk, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want).astype(np.float32), rtol=2**-8, atol=2**-8
    )


BIAS_GRAD_CASES = [
    (70, 4, 1, True, 32, 3e-4),
    (70, 4, 4, False, 32, 3e-4),
    (200, 2, 1, True, 64, 5e-4),  # several tiles, T not a multiple, nk = T as in production
]


@functools.lru_cache(maxsize=None)
def _pallas_bias_grads(t, n_head, kvh, causal, tile):
    """The inputs (B = 2, hd = 16, nk = T) and JAX's custom VJP of its Pallas
    bias kernels (interpret mode) on them: (q, k, v, table, do) and the
    gradients of q, k, v and the table, as numpy arrays."""
    b, hd, nk = 2, 16, t
    q, k, v, table, do = _inputs(b, t, n_head, hd, kvh, nk, seed=t + 3 * kvh)

    def jax_fn(q_, k_, v_, tab):
        return jfa.fused_flash_attention_bias(q_, k_, v_, tab, n_head, nk, causal, tile, True)

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (q, k, v, table)))
    return (q, k, v, table, do), tuple(np.asarray(w) for w in vjp(jnp.asarray(do)))


@pytest.mark.parametrize("t,n_head,kvh,causal,tile,tol", BIAS_GRAD_CASES)
def test_bias_grads_match_pallas_kernels(t, n_head, kvh, causal, tile, tol):
    """dq, dk, dv and the table gradient through the port's autograd (the
    custom op's registered backward) against JAX's custom VJP."""
    (q, k, v, table, do), want = _pallas_bias_grads(t, n_head, kvh, causal, tile)
    tq, tk, tv, ttab = (torch.from_numpy(x).requires_grad_() for x in (q, k, v, table))
    out = tfa.fused_flash_attention_bias(tq, tk, tv, ttab, n_head, t, causal)
    out.backward(torch.from_numpy(do))
    for name, got, w in zip(("q", "k", "v", "table"), (tq, tk, tv, ttab), want):
        np.testing.assert_allclose(
            got.grad.numpy(), np.asarray(w), rtol=tol, atol=tol, err_msg=f"grad of {name}"
        )


@pytest.mark.parametrize("exp2", [False, True])
@pytest.mark.parametrize("t,n_head,kvh,causal,tile,tol", BIAS_GRAD_CASES)
def test_bias_bwd_reference_at_each_exp_matches_pallas_kernels(t, n_head, kvh, causal, tile, tol, exp2):
    """The plain bias backward with p = exp(s - lse) (``exp2=False``) and as
    the tensor-core dQ kernel takes it, 2**(s log2(e) - lse log2(e))
    (``exp2=True``), against JAX's Pallas bias kernels within the tolerance
    above. At ``exp2=False`` it gives the bits of the default, which the
    custom op's backward gives."""
    (q, k, v, table, do), want = _pallas_bias_grads(t, n_head, kvh, causal, tile)
    tq, tk, tv, ttab, tdo = (torch.from_numpy(x) for x in (q, k, v, table, do))
    o, lse = tfa.fused_flash_attention_bias_reference(tq, tk, tv, ttab, n_head, t, causal)
    got = tfa.fused_flash_attention_bias_bwd_reference(tq, tk, tv, ttab, o, lse, tdo, n_head, t, causal, exp2=exp2)
    for name, g, w in zip(("q", "k", "v", "table"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol, err_msg=f"grad of {name}, exp2={exp2}")
    if not exp2:
        default = tfa.fused_flash_attention_bias_bwd_reference(tq, tk, tv, ttab, o, lse, tdo, n_head, t, causal)
        assert all(torch.equal(g, d) for g, d in zip(got, default))
        aq, ak, av, atab = (x.clone().requires_grad_() for x in (tq, tk, tv, ttab))
        tfa.fused_flash_attention_bias(aq, ak, av, atab, n_head, t, causal).backward(tdo)
        assert all(torch.equal(g, x.grad) for g, x in zip(got, (aq, ak, av, atab)))


def test_bias_entry_checks_the_table_and_launches_nothing_on_cpu():
    q, k, v, table, _ = (torch.from_numpy(x) for x in _inputs(1, 16, 2, 16, 1, 16, seed=1))
    kernels = (tfa.FLASH_BIAS_FWD, tfa.FLASH_BIAS_DQ, tfa.FLASH_BIAS_DKV)
    before = [kern.launches for kern in kernels]
    tq = q.clone().requires_grad_()
    tfa.fused_flash_attention_bias(tq, k, v, table, 2, 16, True).sum().backward()
    assert [kern.launches for kern in kernels] == before  # the plain versions launched nothing
    with pytest.raises(ValueError, match="exceeds bias table"):
        tfa.fused_flash_attention_bias(q, k, v, table[:16], 2, 16, True)  # T - 1 + nk >= L
    with pytest.raises(ValueError, match="exceeds bias table"):
        tfa.fused_flash_attention_bias(q, k, v, table, 2, 8, False)  # nk < T - 1 without the mask
    with pytest.raises(ValueError, match="float32"):
        tfa.fused_flash_attention_bias(q, k, v, table.double(), 2, 16, True)


@pytest.mark.parametrize("kind", ["mqa", "mha"])
def test_dispatch_matches_jax_at_513_and_768(monkeypatch, kind):
    """lthm.yaml's own context (T = 513, window 513) takes _sdpa with the
    bias in both packages; T = 768 (BIAS_MIN_SEQ) under a window that covers
    it takes the fused bias path in both."""
    calls = {"jax_fused": 0, "jax_sdpa": 0, "torch_fused": 0, "torch_sdpa": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)

        return wrapped

    def jax_fused_stand_in(q2, k2, v2, table, n_head, nk, causal):
        calls["jax_fused"] += 1
        return jnp.zeros_like(q2)

    monkeypatch.setattr(jfa, "fused_flash_attention_bias", jax_fused_stand_in)
    monkeypatch.setattr(jatt, "_sdpa", counting("jax_sdpa", jatt._sdpa))
    monkeypatch.setattr(tfa, "fused_flash_attention_bias", counting("torch_fused", tfa.fused_flash_attention_bias))
    monkeypatch.setattr(tatt, "_sdpa", counting("torch_sdpa", tatt._sdpa))
    for t, window, path in ((513, 513, "sdpa"), (768, 768, "fused")):
        x = np.random.RandomState(t).randn(1, t, 16).astype(np.float32)
        jcls = jatt.MultiQueryAttention if kind == "mqa" else jatt.MultiHeadAttention
        tcls = tatt.MultiQueryAttention if kind == "mqa" else tatt.MultiHeadAttention
        jm = jcls(n_embd=16, n_head=2, use_bias=False, use_flash=True, pos_bias_window=window)
        vs = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:, :8]), causal=True))
        for key in calls:
            calls[key] = 0
        jm.apply(vs, jnp.asarray(x), causal=True)
        tm = tcls(16, 2, torch.Generator().manual_seed(0), use_bias=False, use_flash=True, pos_bias_window=window)
        tm.load_state_dict(state_dict_from_jax(vs, tm))
        with torch.no_grad():
            tm(torch.from_numpy(x), causal=True)
        assert calls[f"jax_{path}"] == calls[f"torch_{path}"] == 1, (t, calls)
        assert sum(calls.values()) == 2, (t, calls)
