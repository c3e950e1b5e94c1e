"""The port's LTHM loss pieces (recommendations_tpu_torch.nn.logq and
.models.lthm.loss) against the JAX package's, on the CPU, on the same numpy
inputs: the logQ estimator (exact), ``_ce_core`` forward and backward, and
``contrastive_step`` with every metric key.

The JAX side runs op by op (``jax.disable_jit()`` where its scan would
compile the chunk body): compiled, XLA's CPU backend turns the bf16-output
logits GEMM into an f32 GEMM and drops the bf16 storage that
``models/lthm/loss.py:63-72`` prescribes and the port keeps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.models.lthm import loss as jloss
from recommendations_tpu.nn import logq as jlogq
from recommendations_tpu_torch.models.lthm import loss as tloss
from recommendations_tpu_torch.nn import logq as tlogq

torch.set_num_threads(1)

TOL = 1e-4  # loss and metrics, f32


def _ids(shape, seed, pad_frac=0.2):
    """Ids over the whole int64 range, negatives and the extremes included,
    with pad ids (0)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(-(2**63), 2**63 - 1, size=shape, dtype=np.int64)
    flat = ids.reshape(-1)
    flat[:4] = [-(2**63), 2**63 - 1, -1, 1]
    flat[rs.rand(flat.size) < pad_frac] = 0
    return ids


@pytest.mark.parametrize("offsets", [[0], [0, 34144, 7465477], [2**62, -5]])
def test_logq_buckets_and_correction_match_jax(offsets):
    ids = _ids((5, 40), seed=1)
    js = jlogq.init_logq_state(64, offsets, 0.01)
    ts = tlogq.init_logq_state(64, offsets, 0.01)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tlogq._buckets(ts, torch.from_numpy(ids)).numpy(), np.asarray(jlogq._buckets(js, ids))
    )
    # a state with distinct values, so the correction reads the right buckets
    rs = np.random.RandomState(2)
    b = rs.uniform(1, 500, size=(len(offsets), 64)).astype(np.float32)
    js = js._replace(b=jnp.asarray(b))
    ts = ts._replace(b=torch.from_numpy(b))
    # the bucket minimum is exact; -log differs in the last bit at most
    # (XLA's and PyTorch's log are different polynomial approximations)
    h = np.asarray(jlogq._buckets(js, ids))
    min_b = np.take_along_axis(b, h, axis=1).min(0).reshape(ids.shape)
    got = tlogq.logq_correction(ts, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, -torch.log(torch.from_numpy(min_b)).numpy())
    np.testing.assert_array_max_ulp(got, np.asarray(jlogq.logq_correction(js, jnp.asarray(ids))), maxulp=1)


def _sort_and_index_update(state, ids, valid, batch_idx, alpha):
    """The update as the port first wrote it: each bucket's last occurrence
    picked out by a boolean index (a host read of the device's values),
    then written at unique indices."""
    h = tlogq._buckets(state, ids)
    v = valid.reshape(-1)
    bi = torch.as_tensor(batch_idx, dtype=torch.float32)
    b_new, a_new = state.b.clone(), state.a.clone()
    for row in range(h.shape[0]):
        order = torch.sort(h[row], stable=True).indices
        sorted_h = h[row][order]
        last = torch.ones_like(sorted_h, dtype=torch.bool)
        last[:-1] = sorted_h[1:] != sorted_h[:-1]
        keep = order[last]
        hk, vk = h[row, keep], v[keep]
        b_old, a_old = state.b[row, hk], state.a[row, hk]
        b_new[row, hk] = torch.where(vk, (1.0 - alpha) * b_old + alpha * (bi - a_old), b_old)
        a_new[row, hk] = torch.where(vk, bi, a_old)
    return tlogq.LogQState(b=b_new, a=a_new, hash_offsets=state.hash_offsets)


@pytest.mark.parametrize("num_buckets,pad_frac", [(64, 0.3), (7, 0.3), (3, 0.6)])
def test_logq_update_matches_jax_with_colliding_buckets(num_buckets, pad_frac):
    """``num_buckets`` buckets for 600 ids: real ids collide with each other
    and with the pad id 0; the last write in flattened order wins, pad or
    not. Held to JAX and to the sort-and-index update bit for bit."""
    offsets = [0, 34144, 7465477]
    ids = _ids((6, 100), seed=3, pad_frac=pad_frac)
    valid = ids != 0
    js = jlogq.init_logq_state(num_buckets, offsets, 0.01)
    ts = tlogq.init_logq_state(num_buckets, offsets, 0.01)
    old = ts
    for step in range(3):
        step_ids = np.roll(ids, step * 7, axis=1)
        step_valid = np.roll(valid, step * 7, axis=1)
        js = jlogq.logq_update(js, jnp.asarray(step_ids), jnp.asarray(step_valid), jnp.float32(step), 0.05)
        ts = tlogq.logq_update(ts, torch.from_numpy(step_ids), torch.from_numpy(step_valid), step, 0.05)
        old = _sort_and_index_update(old, torch.from_numpy(step_ids), torch.from_numpy(step_valid), step, 0.05)
        np.testing.assert_array_equal(ts.b.numpy(), np.asarray(js.b), err_msg=f"b, step {step}")
        np.testing.assert_array_equal(ts.a.numpy(), np.asarray(js.a), err_msg=f"a, step {step}")
        assert torch.equal(ts.b, old.b) and torch.equal(ts.a, old.a), f"step {step}"
    h = tlogq._buckets(ts, torch.from_numpy(ids))[0]
    assert len(set(h.tolist())) < h.numel()  # buckets did repeat
    # some bucket's last occurrence is a pad id, another's a real id
    last_valid = {}
    for bucket, ok in zip(h.tolist(), valid.reshape(-1).tolist()):
        last_valid[bucket] = ok
    assert set(last_valid.values()) == {False, True}


def test_lookahead_index_gathers_as_roll():
    """Slot j of head i reads (j + offset_i) mod s: ``torch.roll`` by
    -offset_i, for every offset from 0 to s."""
    s = 9
    x = torch.arange(2 * s * 3, dtype=torch.float32).reshape(2, s, 3)
    offsets = torch.arange(s + 1)
    index = tloss.lookahead_index(offsets, s)
    for off in range(s + 1):
        assert torch.equal(x.index_select(1, index[off]), torch.roll(x, -off, dims=1)), off


def test_logq_update_does_not_touch_its_input():
    ts = tlogq.init_logq_state(64, [0], 0.01)
    before = ts.b.clone()
    tlogq.logq_update(ts, torch.arange(10), torch.ones(10, dtype=torch.bool), 3, 0.05)
    assert torch.equal(ts.b, before)


def _ce_inputs(n_users, s, d, seed, all_invalid_user=False):
    rs = np.random.RandomState(seed)
    n = n_users * s

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    q = unit(rs.randn(n, d)).astype(np.float32)
    c = unit(rs.randn(n, d)).astype(np.float32)
    v = rs.rand(n) > 0.2
    if all_invalid_user:
        v[:] = False  # every row fully masked: ce = -inf
        v[s : 2 * s] = True
    lq = -np.log(rs.uniform(1, 200, size=n)).astype(np.float32)
    g = rs.randn(n).astype(np.float32)
    return q, c, v, lq, g


@pytest.mark.parametrize("beta", [0.0, 0.5])
@pytest.mark.parametrize("all_invalid_user", [False, True])
def test_ce_core_forward_and_backward_match_jax(beta, all_invalid_user):
    s, inv_t = 12, 20.0
    q, c, v, lq, g = _ce_inputs(3, s, 16, seed=4, all_invalid_user=all_invalid_user)
    q16, c16 = jnp.asarray(q, jnp.bfloat16), jnp.asarray(c, jnp.bfloat16)

    def jf(q16, c16):
        ce, rank = jloss._ce_core(q16, c16, jnp.asarray(v), jnp.asarray(lq), s, inv_t, beta)
        return jnp.sum(jnp.where(jnp.isfinite(ce), ce, 0.0) * g), (ce, rank)

    (_, (jce, jrank)), (jdq, jdc) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(q16, c16)
    tq = torch.tensor(np.asarray(q16.astype(jnp.float32))).bfloat16().requires_grad_()
    tc = torch.tensor(np.asarray(c16.astype(jnp.float32))).bfloat16().requires_grad_()
    tce, trank = tloss._ce_rows(tq, tc, torch.from_numpy(v), torch.from_numpy(lq), s, 1.0 / inv_t, beta,
                                fused_ce=False)
    (torch.where(torch.isfinite(tce), tce, 0.0) * torch.from_numpy(g)).sum().backward()

    np.testing.assert_array_equal(trank.numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(np.isfinite(tce.detach().numpy()), np.isfinite(np.asarray(jce)))
    fin = np.isfinite(np.asarray(jce))
    np.testing.assert_allclose(tce.detach().numpy()[fin], np.asarray(jce)[fin], rtol=0, atol=TOL)
    for got, want in ((tq.grad, jdq), (tc.grad, jdc)):
        got = got.float().numpy()
        assert np.isfinite(got).all()
        # bf16 outputs of f32-accumulated products: one bf16 ulp of the largest
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                                   atol=2**-8 * np.abs(np.asarray(want, np.float32)).max())


def _output(b, s, k, d, seed):
    rs = np.random.RandomState(seed)
    mask = rs.rand(b, s) < 0.15
    mask[1, :5] = True
    ids = _ids((b, s), seed + 1, pad_frac=0.0)
    ids[mask] = 0
    return {
        "next_token_emb": rs.randn(b, s + 1, k, d).astype(np.float32),
        "current_token_emb": rs.randn(b, s, d).astype(np.float32),
        "current_token_mask": mask,
        "current_token_ids": ids,
    }


@pytest.mark.parametrize("offsets_on", ["host", "device"])
@pytest.mark.parametrize(
    "beta,mini_batch,training",
    [
        (0.0, -1, True),
        (0.5, -1, True),
        (0.5, 2, True),    # two chunks: the JAX package's scan
        (0.0, 3, True),    # a ragged last chunk: its python loop
        (0.5, 2, False),   # val: no logQ update, one chunk
    ],
)
def test_contrastive_step_matches_jax(beta, mini_batch, training, offsets_on):
    """``offsets_on``: the offsets as a numpy array, or as the int64 tensor
    on the loss's device that a captured step passes."""
    b, s, lookahead, d = 4, 20, [0, 2, 5], 16
    out = _output(b, s, len(lookahead), d, seed=7)
    rng = jax.random.PRNGKey(5)
    offsets = np.asarray(jloss.sample_offsets(jax.random.split(rng)[1], lookahead))
    if offsets_on == "device":
        offsets = torch.from_numpy(offsets.astype(np.int64))
    kw = dict(
        lookahead=lookahead, temperature=0.05, beta=beta, alpha=0.05,
        metrics_k_all=[1, 5, 20], train_mini_batch_size=mini_batch, training=training,
    )
    js = jlogq.init_logq_state(64, [0, 7], 0.01)
    with jax.disable_jit():
        jl, jm, jst = jloss.contrastive_step(
            {k: jnp.asarray(v) for k, v in out.items()}, js, jnp.float32(3), jax.random.split(rng)[1], **kw
        )
    ts = tlogq.init_logq_state(64, [0, 7], 0.01)
    tl, tm, tst = tloss.contrastive_step(
        {k: torch.from_numpy(v) for k, v in out.items()}, ts, torch.tensor(3.0), offsets=offsets, **kw
    )
    assert set(tm) == set(jm)
    assert abs(float(tl) - float(jl)) <= TOL
    for key in jm:
        # the median of a chunk with no weighted row is NaN on both sides
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=0, atol=TOL, err_msg=key)
    np.testing.assert_array_equal(tst.b.numpy(), np.asarray(jst.b))
    np.testing.assert_array_equal(tst.a.numpy(), np.asarray(jst.a))


def test_sample_offsets_distribution():
    g = torch.Generator().manual_seed(0)
    lookahead = [0, 5, 6, 12, 24, 30]
    draws = np.stack([tloss.sample_offsets(g, lookahead).numpy() for _ in range(400)])
    assert (draws[:, 0] == 0).all()
    assert (np.diff(draws, axis=1) >= 1).all()
    assert (draws <= np.asarray(lookahead)).all()
    assert set(draws[:, 1]) == {1, 2, 3, 4, 5}  # U(1, 5), both ends included
    assert tloss.sample_offsets(g, [0, 1, 1]).tolist() == [0, 1, 2]  # empty range: its low end

