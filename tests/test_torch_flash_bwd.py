"""The port's flash-attention backward (recommendations_tpu_torch.ops.
fused_attention) against the JAX package's, on the CPU.

``jax.grad`` through the JAX ``fused_flash_attention`` runs its Pallas
backward kernels in interpret mode, as tests/test_fused_attention.py runs
them; T in {70, 257, 450, 1100} covers its three dispatch regimes (one fused
kernel, the two-kernel tiles, the grid kernels). The port's gradient goes
through the flash operator (``FLASH_OP``), whose backward on CPU tensors is
the plain version of the CUDA kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.ops import fused_attention as jfa
from recommendations_tpu_torch.ops import fused_attention as tfa

torch.set_num_threads(1)

GRAD_TOL = 2e-4  # as tests/test_fused_attention.py:82


def _inputs(b, t, n_head, hd, kvh, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, t, n_head * hd).astype(np.float32)
    k = rs.randn(b, t, kvh * hd).astype(np.float32)
    v = rs.randn(b, t, kvh * hd).astype(np.float32)
    cot = rs.randn(b, t, n_head * hd).astype(np.float32)
    return q, k, v, cot


def _jax_grads(q, k, v, cot, n_head, causal):
    def loss(q, k, v):
        o = jfa.fused_flash_attention(q, k, v, n_head, causal, None, True)
        return jnp.sum(o.astype(jnp.float32) * cot)

    return [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _port_grads(q, k, v, cot, n_head, causal, dtype=torch.float32):
    ts = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = tfa.fused_flash_attention(*ts, n_head, causal)
    (o.float() * torch.from_numpy(cot)).sum().backward()
    return o, [x.grad.float().numpy() for x in ts]


@pytest.mark.parametrize(
    "b,t,n_head,hd,kvh,causal",
    [
        (2, 70, 4, 16, 1, True),     # _bwd_fused_kernel, MQA
        (2, 70, 4, 16, 4, False),    # _bwd_fused_kernel, MHA, non-causal
        (1, 257, 2, 8, 1, True),     # _bwd_fused_kernel at the LTHM length
        (1, 450, 2, 8, 1, True),     # _dq_kernel / _dkv_kernel
        (1, 450, 2, 8, 2, False),
        (1, 1100, 2, 8, 2, True),    # _dq_kernel_grid / _dkv_kernel_grid
        (1, 1100, 2, 8, 1, False),
    ],
)
def test_flash_backward_matches_jax_f32(b, t, n_head, hd, kvh, causal):
    q, k, v, cot = _inputs(b, t, n_head, hd, kvh, seed=t + kvh)
    want = _jax_grads(q, k, v, cot, n_head, causal)
    _, got = _port_grads(q, k, v, cot, n_head, causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"d{name}")


def test_flash_backward_matches_jax_bf16():
    """bf16 operands: both sides round qs, ds and p before the products and
    each output once, in sums of different order; held at 2**-8 of the
    largest gradient (one bf16 ulp there)."""
    b, t, n_head, hd, kvh = 2, 70, 4, 16, 1
    q, k, v, cot = _inputs(b, t, n_head, hd, kvh, seed=3)
    bq, bk, bv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = _jax_grads(bq, bk, bv, cot, n_head, True)
    qs, ks, vs = (np.asarray(x.astype(jnp.float32)) for x in (bq, bk, bv))
    _, got = _port_grads(qs, ks, vs, cot, n_head, True, torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        assert np.abs(g - w).max() <= 2**-8 * np.abs(w).max(), f"d{name}"


def test_flash_output_carries_the_flash_backward(monkeypatch):
    """On a CPU tensor the output's grad_fn is the flash operator's backward
    (which runs the kernel's plain version, once), not autograd through the
    plain forward."""
    calls = []
    real = tfa.fused_flash_attention_bwd
    monkeypatch.setattr(tfa, "fused_flash_attention_bwd", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v, cot = _inputs(1, 40, 2, 16, 1, seed=5)
    o, _ = _port_grads(q, k, v, cot, 2, True)
    assert "flash_attention_default" in o.grad_fn.name()
    assert len(calls) == 1


@pytest.mark.parametrize("kvh", [1, 2])
def test_backward_plain_version_matches_autograd(kvh):
    """The plain backward against autograd through the plain forward, f32."""
    q, k, v, cot = _inputs(2, 33, 2, 8, kvh, seed=11)
    ts = [torch.tensor(x, dtype=torch.float64).float().requires_grad_() for x in (q, k, v)]
    o, lse = tfa.fused_flash_attention_reference(*ts, 2, True)
    (o * torch.from_numpy(cot)).sum().backward()
    got = tfa.fused_flash_attention_bwd_reference(
        *(x.detach() for x in ts), o.detach(), lse.detach(), torch.from_numpy(cot), 2, True
    )
    for g, x in zip(got, ts):
        torch.testing.assert_close(g, x.grad, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_backward_rounds_the_cotangent_to_q_dtype():
    q, k, v, cot = _inputs(1, 20, 2, 16, 1, seed=2)
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    o, lse = tfa.fused_flash_attention_fwd(tq, tk, tv, 2)
    f32 = tfa.fused_flash_attention_bwd(tq, tk, tv, o, lse, torch.from_numpy(cot), 2)
    rounded = tfa.fused_flash_attention_bwd(tq, tk, tv, o, lse, torch.from_numpy(cot).bfloat16(), 2)
    for a, b in zip(f32, rounded):
        assert torch.equal(a, b)
