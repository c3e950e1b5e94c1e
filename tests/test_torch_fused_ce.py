"""The port's fused contrastive CE (recommendations_tpu_torch.ops.fused_ce)
against the JAX package's (recommendations_tpu.ops.fused_ce, interpret mode),
on the CPU, on the same numpy inputs: the module (ce, rank, dq, dc), the
loss step with ``fused_ce=True``, and one training step through the wrapper.

On the CPU the port runs the kernels' plain versions; the card holds the
kernels to those (tests/test_torch_cuda_kernels.py, chip_smoke.py).

Rank: the port counts the columns j != i whose logit exceeds the positive's,
as the JAX package's unfused ``_ce_core`` does, and equals it on f32-upcast
operands. The JAX fused kernel also counts column i where its tile product
q_i.c_i exceeds its separately summed diagonal, so its rank is the port's or
one more; the tests hold that one-sided difference and print how many rows
it touches."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.models.lthm import loss as jloss
from recommendations_tpu.nn import logq as jlogq
from recommendations_tpu.ops.fused_ce import _fwd_impl as jax_fwd_impl
from recommendations_tpu.ops.fused_ce import fused_contrastive_ce as jax_fused_ce
from recommendations_tpu_torch.models.lthm import loss as tloss
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.nn import logq as tlogq
from recommendations_tpu_torch.ops import fused_ce as tfc
from tests.test_torch_loss import _output
from tests.test_torch_train import (
    TOL,
    _check_grads,
    _grads_by_name,
    _offsets,
    _pair,
    small_batch,
    small_config,
)

torch.set_num_threads(1)

CE_TOL = 2e-5  # f32 ce, absolute and relative: tests/test_fused_ce.py's
INV_T = 20.0


def _inputs(n, s, d, seed, invalid=0.2, all_invalid_user=False):
    """Unit rows rounded to bf16 (as float32 numpy), validity, logQ and a
    weight per row that is 0 where the row is invalid."""
    rs = np.random.RandomState(seed)

    def unit(x):
        x = x / np.linalg.norm(x, axis=-1, keepdims=True)
        return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    q, c = unit(rs.randn(n, d)), unit(rs.randn(n, d))
    v = rs.rand(n) >= invalid
    if all_invalid_user:
        v[s : 2 * s] = False
    lq = (-np.abs(rs.randn(n)) * 3.0).astype(np.float32)
    w = (rs.uniform(size=n) * v).astype(np.float32)
    return q, c, v, lq, w


def _jax(q, c, v, lq):
    return tuple(jnp.asarray(x, dt) for x, dt in ((q, jnp.bfloat16), (c, jnp.bfloat16), (v, bool), (lq, jnp.float32)))


def _torch(q, c, v, lq):
    return torch.tensor(q).bfloat16(), torch.tensor(c).bfloat16(), torch.tensor(v), torch.tensor(lq)


# (n, s, d, beta, invalid fraction, one user all invalid)
CASES = [
    (64, 8, 16, 1.0, 0.2, False),     # tests/test_fused_ce.py's shapes
    (96, 12, 16, 1.0, 0.2, False),
    (100, 10, 16, 1.0, 0.2, False),   # n not a multiple of the TPU's tiles
    (100, 10, 16, 0.0, 0.2, False),
    (32, 32, 16, 0.5, 0.0, False),    # one user: every off-diagonal column masked
    (96, 12, 16, 1.0, 0.2, True),     # a user with every slot invalid
    (512, 32, 128, 0.0, 0.1, False),  # the path's width
    (512, 32, 128, 1.0, 0.1, False),
]


@pytest.mark.parametrize("n,s,d,beta,invalid,all_invalid_user", CASES)
def test_fused_ce_forward_matches_jax(n, s, d, beta, invalid, all_invalid_user):
    q, c, v, lq, _ = _inputs(n, s, d, seed=n + d, invalid=invalid, all_invalid_user=all_invalid_user)
    jce, jrank = (np.asarray(x) for x in jax_fused_ce(*_jax(q, c, v, lq), s, INV_T, beta, None, None, True))
    _, core_rank = jloss._ce_core(jnp.asarray(q), jnp.asarray(c), jnp.asarray(v), jnp.asarray(lq), s, INV_T, beta)
    tce, trank = tfc.fused_contrastive_ce(*_torch(q, c, v, lq), s, INV_T, beta)
    tce, trank = tce.numpy(), trank.numpy()
    assert tce.dtype == np.float32 and trank.dtype == np.int32

    # every valid row, and the huge but finite ce of invalid rows; a fully
    # masked row is -inf on both sides
    fin = np.isfinite(jce)
    np.testing.assert_array_equal(np.isfinite(tce), fin)
    np.testing.assert_array_equal(tce[~fin], jce[~fin])
    np.testing.assert_allclose(tce[fin], jce[fin], rtol=CE_TOL, atol=CE_TOL)
    if invalid:
        assert (tce[~v & fin] > 1e8).all()

    np.testing.assert_array_equal(trank, np.asarray(core_rank))
    extra = jrank - trank
    assert set(np.unique(extra)) <= {0, 1}
    print(f"n={n} d={d} beta={beta}: JAX fused rank one higher on {int(extra.sum())} of {n} rows")


@pytest.mark.parametrize("n,s,d,beta,invalid,all_invalid_user", CASES)
def test_fused_ce_grads_match_jax(n, s, d, beta, invalid, all_invalid_user):
    """dq and dc of sum(ce * w): both round g to bf16 at the same place and
    each gradient once after an f32 sum, so they differ by f32 sum order and
    the exp's last bits, which can move an output to its neighbouring bf16
    value: one bf16 ulp of the largest element. Where the gradient vanishes
    (one user: every off-diagonal column is masked, so p_ii = 1 up to the
    rounding of lse, an f32 ulp of about 2**-19 at |lse| ~ 20), both sides
    hold that rounding times dce * inv_t: an absolute floor of 2**-16 * inv_t."""
    q, c, v, lq, w = _inputs(n, s, d, seed=7 * n + d, invalid=invalid, all_invalid_user=all_invalid_user)
    jq, jc, jv, jlq = _jax(q, c, v, lq)

    def jloss_fn(q16, c16):
        ce, _ = jax_fused_ce(q16, c16, jv, jlq, s, INV_T, beta, None, None, True)
        return jnp.sum(jnp.where(jnp.isfinite(ce), ce, 0.0) * w)

    want = jax.grad(jloss_fn, argnums=(0, 1))(jq, jc)
    tq, tc, tv, tlq = _torch(q, c, v, lq)
    tq.requires_grad_(), tc.requires_grad_()
    ce, _ = tfc.fused_contrastive_ce(tq, tc, tv, tlq, s, INV_T, beta)
    (torch.where(torch.isfinite(ce), ce, 0.0) * torch.from_numpy(w)).sum().backward()
    for name, got, ref in (("dq", tq.grad, want[0]), ("dc", tc.grad, want[1])):
        ref = np.asarray(ref, np.float32)
        assert got.dtype == torch.bfloat16, name
        got = got.float().numpy()
        assert np.isfinite(got).all(), name
        atol = max(2**-8 * np.abs(ref).max(), 2**-16 * INV_T)
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=name)


# (n, s, d, beta, invalid fraction, one user all invalid, inv_t, max|lq| or
# None): CASES at INV_T, and a temperature of 0.07 with a max|lq| at which
# the shift's order moves its last bit (beta * max + (inv_t + 1) gives
# 16.54646873474121, JAX's order 16.546466827392578)
SHIFT_CASES = [(*case, INV_T, None) for case in CASES] + [
    (96, 12, 16, 1.0, 0.2, False, 1 / 0.07, 1.260753870010376),
]


@pytest.mark.parametrize("n,s,d,beta,invalid,all_invalid_user,inv_t,lq_max", SHIFT_CASES)
def test_row_diag_and_shift_match_jax(n, s, d, beta, invalid, all_invalid_user, inv_t, lq_max):
    """The plain pair of ``ce_row_diag`` (the kernel's oracle on the card)
    against JAX's ``_fwd_impl`` in interpret mode: its ``_row_diag_kernel``
    output within the JAX kernel tests' 2e-5, and its shift m bit for bit."""
    q, c, v, lq, _ = _inputs(n, s, d, seed=3 * n + d, invalid=invalid, all_invalid_user=all_invalid_user)
    if lq_max is not None:
        lq = np.clip(lq, -1.0, 0.0)
        lq[n // 3] = -np.float32(lq_max)
    _, _, res = jax_fwd_impl(*_jax(q, c, v, lq), s, inv_t, beta, None, None, True)
    jdiag = np.asarray(res[5]).reshape(-1)[:n]
    jm = np.asarray(res[4], np.float32).reshape(())
    tdiag, tm = tfc.row_diag_and_shift_reference(*_torch(q, c, v, lq), inv_t, beta)
    assert tdiag.dtype == tm.dtype == torch.float32 and tm.shape == ()
    np.testing.assert_allclose(tdiag.numpy(), jdiag, rtol=CE_TOL, atol=CE_TOL)
    np.testing.assert_array_equal(tdiag.numpy()[~v], jdiag[~v])
    assert tm.numpy().view(np.int32) == jm.view(np.int32), (float(tm), float(jm))


def test_fused_ce_on_cpu_runs_the_plain_version():
    q, c, v, lq, _ = _inputs(64, 8, 16, seed=1)
    before = [k.launches for k in tfc.KERNELS]
    args = _torch(q, c, v, lq)
    ce, rank, lse = tfc.ce_forward(*args, 8, INV_T, 1.0)
    np.testing.assert_array_equal(
        ce.numpy(), tfc.ce_forward_reference(*args, 8, INV_T, 1.0)[0].numpy()
    )
    tfc.ce_backward(*args, lse, torch.ones(64), 8, INV_T, 1.0)
    assert [k.launches for k in tfc.KERNELS] == before
    with pytest.raises(ValueError, match="expected q, c"):
        tfc.fused_contrastive_ce(args[0], args[1][:10], *args[2:], 8, INV_T, 1.0)
    with pytest.raises(TypeError, match="bool"):
        tfc.fused_contrastive_ce(*args[:2], args[2].float(), args[3], 8, INV_T, 1.0)


# -- the slice: the loss step and the training step ----------------------------


def _rank_key(key):
    return "hit_" in key  # average/median hit position and hit_rate_at_k


def _check_one_sided(tm, jm):
    """Metrics not derived from rank at 1e-4; the rank-derived ones hold the
    JAX fused kernel's one-sided difference: its hit positions are never
    below the port's and its hit rates never above."""
    assert set(tm) >= set(jm)
    shifted = 0
    for key in jm:
        got, want = float(tm[key]), float(jm[key])
        if not _rank_key(key):
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=key)
        elif "hit_rate" in key:
            assert want <= got + TOL, key
            shifted += want < got - TOL
        else:
            assert (np.isnan(got) and np.isnan(want)) or want >= got - TOL, key
            shifted += want > got + TOL
    print(f"{shifted} rank-derived metrics moved by the JAX kernel's self-count")


@pytest.mark.parametrize(
    "beta,mini_batch,training",
    [(0.0, -1, True), (1.0, -1, True), (0.5, 2, True), (0.5, 2, False)],
)
def test_contrastive_step_fused_matches_jax(beta, mini_batch, training):
    b, s, lookahead, d = 4, 24, [0, 2, 5], 16
    out = _output(b, s, len(lookahead), d, seed=11)
    rng = jax.random.PRNGKey(5)
    offsets = np.asarray(jloss.sample_offsets(jax.random.split(rng)[1], lookahead))
    kw = dict(
        lookahead=lookahead, temperature=0.05, beta=beta, alpha=0.05, metrics_k_all=[1, 5, 20],
        train_mini_batch_size=mini_batch, training=training, fused_ce=True,
    )
    jl, jm, jst = jloss.contrastive_step(
        {k: jnp.asarray(v) for k, v in out.items()}, jlogq.init_logq_state(64, [0, 7], 0.01),
        jnp.float32(3), jax.random.split(rng)[1], **kw,
    )
    tl, tm, tst = tloss.contrastive_step(
        {k: torch.from_numpy(v) for k, v in out.items()}, tlogq.init_logq_state(64, [0, 7], 0.01),
        torch.tensor(3.0), offsets=offsets, **kw,
    )
    assert set(tm) == set(jm)
    assert abs(float(tl) - float(jl)) <= TOL
    _check_one_sided(tm, jm)
    np.testing.assert_array_equal(tst.b.numpy(), np.asarray(jst.b))
    np.testing.assert_array_equal(tst.a.numpy(), np.asarray(jst.a))


@pytest.mark.parametrize("beta,mini_batch", [(0.0, -1), (0.5, 3)])
def test_fused_training_step_matches_jax(beta, mini_batch):
    """One step through ``loss_and_metrics`` with ``fused_ce=True`` on the
    small float32 model with converted weights: loss and metrics as above,
    every gradient within test_torch_train.py's tolerances."""
    d = small_config(True, "float32", beta, mini_batch, fused_ce=True)
    jw, vs, tw = _pair(d)
    assert tw.config.fused_ce
    batch = small_batch()
    rng = jax.random.PRNGKey(3)
    aux = jw.init_aux_state()

    def loss_fn(p):
        return jw.loss_and_metrics(p, vs["constants"], aux, {k: jnp.asarray(v) for k, v in batch.items()}, rng, True)

    (jl, (jm, jaux)), jg = jax.value_and_grad(loss_fn, has_aux=True)(vs["params"])
    before = [k.launches for k in tfc.KERNELS]
    tl, tm, taux = tw.loss_and_metrics(batch, tw.init_aux_state(), True, offsets=_offsets(rng, d["lookahead"]))
    tl.backward()
    assert [k.launches for k in tfc.KERNELS] == before  # CPU: the plain versions
    assert abs(tl.item() - float(jl)) <= TOL
    _check_one_sided(tm, jm)
    _check_grads(tw, _grads_by_name(tw, jg, vs))
    np.testing.assert_array_equal(taux.logq.b.numpy(), np.asarray(jaux.logq.b))


def test_fused_and_unfused_ce_train_the_same_loss():
    """The port's two CE paths on one model: they differ only by the bf16
    storage of the unfused path's logits (a quantum of 2**-8 relative at
    |logit| <= 20), which moves the loss by far less than 1e-2 here."""
    losses = []
    for fused in (False, True):
        tw = LTHMModelWrapper(
            LTHMModelConfig.from_dict(small_config(True, "float32", 0.5, 3, fused_ce=fused)), device="cpu", seed=4
        )
        loss, metrics, _ = tw.loss_and_metrics(small_batch(seed=2), tw.init_aux_state(), True, offsets=[0, 1, 3])
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) <= 1e-2


# -- the rounded case: the eager CE's function on the CE kernels ----------------


def grid_unit_rows(g: torch.Generator, n: int, d: int, device=None) -> torch.Tensor:
    """(n, d) bf16 rows of unit norm up to the grid: every element a multiple
    of 2**-10 and a bf16 value, so every product is a multiple of 2**-20 and
    every partial sum of a row dot (at most about 1 in magnitude) is exact in
    float32. S = q.c^T is then the same in any order of summation, and its
    bf16 rounding the same in every implementation."""
    x = torch.nn.functional.normalize(torch.randn(n, d, generator=g), dim=-1).bfloat16().float()
    return (torch.round(x * 1024.0) / 1024.0).bfloat16().to(device)


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("all_invalid_user", [False, True])
@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_rounded_plain_versions_give_ce_core(beta, all_invalid_user, d):
    """The rounded plain versions (``round_logits=True``) against the JAX
    package's ``_ce_core`` (op by op, as ``tests/test_torch_loss.py`` runs
    it), on grid rows whose products are exact in float32, so both round
    the same S to bf16. ce: 2e-6 (1 + |ce|), the same float32 operations on
    the same logits, a reduction blocked otherwise at most; rank: equal; dq,
    dc: one bf16 ulp of the largest element (the same bf16 g, its products
    summed in another order). The unrounded plain version misses
    ``_ce_core``'s ce by more than that, so the test sees the rounding."""
    n_users, s = 4, 24
    n = n_users * s
    g = torch.Generator().manual_seed(d + int(all_invalid_user))
    q, c = grid_unit_rows(g, n, d), grid_unit_rows(g, n, d)
    v = torch.rand(n, generator=g) >= 0.15
    if all_invalid_user:
        v[s: 2 * s] = False
    lq = -torch.log(torch.rand(n, generator=g) * 200.0 + 1.0)
    dce = torch.rand(n, generator=g) * v

    ce, rank, lse = tfc.ce_forward_reference(q, c, v, lq, s, INV_T, beta, round_logits=True)
    dq, dc = tfc.ce_backward_reference(q, c, v, lq, lse, dce, s, INV_T, beta, round_logits=True)

    jv, jlq, jdce = jnp.asarray(v.numpy()), jnp.asarray(lq.numpy()), jnp.asarray(dce.numpy())

    def jf(q16, c16):
        jce, jrank = jloss._ce_core(q16, c16, jv, jlq, s, INV_T, beta)
        return jnp.sum(jnp.where(jnp.isfinite(jce), jce, 0.0) * jdce), (jce, jrank)

    jq, jc = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, c))
    (_, (jce, jrank)), (jdq, jdc) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(jq, jc)
    want_ce, want_dq, want_dc = (torch.tensor(np.asarray(x, np.float32)) for x in (jce, jdq, jdc))
    want_rank = torch.tensor(np.asarray(jrank))
    fin = torch.isfinite(want_ce)
    assert torch.equal(torch.isfinite(ce), fin)
    err = ((ce - want_ce).abs() / (1.0 + want_ce.abs()))[fin].max().item()
    assert err <= 2e-6, err
    assert torch.equal(rank, want_rank.to(rank.dtype))
    for got, want in ((dq, want_dq), (dc, want_dc)):
        assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
        assert (got.float() - want).abs().max().item() <= 2**-8 * want.abs().max().item()
    unrounded = tfc.ce_forward_reference(q, c, v, lq, s, INV_T, beta)[0]
    assert ((unrounded - want_ce).abs() / (1.0 + want_ce.abs()))[fin].max().item() > 1e-4


def test_rounded_route_on_cpu_runs_the_rounded_plain_versions():
    """``fused_contrastive_ce(round_logits=True)`` on CPU tensors: the
    rounded plain versions, bit for bit, and no kernel launched."""
    g = torch.Generator().manual_seed(3)
    q, c = grid_unit_rows(g, 64, 16), grid_unit_rows(g, 64, 16)
    v, lq = torch.rand(64, generator=g) >= 0.2, -torch.rand(64, generator=g) * 5.0
    before = [k.launches for k in (*tfc.KERNELS, *tfc.ROUNDED_KERNELS)]
    ce, rank = tfc.fused_contrastive_ce(q, c, v, lq, 8, INV_T, 1.0, round_logits=True)
    want_ce, want_rank, _ = tfc.ce_forward_reference(q, c, v, lq, 8, INV_T, 1.0, round_logits=True)
    assert torch.equal(ce, want_ce) and torch.equal(rank, want_rank)
    assert [k.launches for k in (*tfc.KERNELS, *tfc.ROUNDED_KERNELS)] == before


@pytest.mark.parametrize("fused_ce", [False, True])
def test_ce_rows_routes_each_setting(fused_ce):
    """``_ce_rows`` calls the fused CE once on any device, with bf16-stored
    logits (``round_logits``) where ``fused_ce`` is unset, and returns what
    it returned."""
    g = torch.Generator().manual_seed(4)
    q, c = grid_unit_rows(g, 48, 32), grid_unit_rows(g, 48, 32)
    v, lq = torch.rand(48, generator=g) >= 0.2, -torch.rand(48, generator=g) * 5.0
    calls = []

    def fused(*args, **kwargs):
        calls.append((kwargs, tfc.fused_contrastive_ce(*args, **kwargs)))
        return calls[-1][1]

    with mock.patch.object(tloss, "fused_contrastive_ce", fused):
        ce, rank = tloss._ce_rows(q, c, v, lq, 12, 0.05, 0.5, fused_ce)
    (kwargs, (got_ce, got_rank)), = calls
    assert kwargs["round_logits"] is (not fused_ce)
    assert torch.equal(ce, got_ce) and torch.equal(rank, got_rank)
    want = tfc.ce_forward_reference(q, c, v, lq, 12, 20.0, 0.5, round_logits=not fused_ce)[:2]
    assert torch.equal(ce, want[0]) and torch.equal(rank, want[1])


@pytest.mark.parametrize("width, device, refused", [
    (48, "cuda", True), (256, "cuda", True), (128, "cuda", False), (16, "cuda:0", False), (48, "cpu", False),
])
def test_check_ce_width(width, device, refused):
    """On a CUDA device either CE setting runs the CE kernels, which take the
    widths 16, 32, 64 and 128 only; the CPU's plain versions take any. (No
    tensor is made, so the check runs without a card.)"""
    if refused:
        with pytest.raises(ValueError, match=f"product_emb_dim {width}"):
            tloss.check_ce_width(width, torch.device(device))
    else:
        tloss.check_ce_width(width, torch.device(device))


@pytest.mark.parametrize("fused_ce", [False, True])
def test_init_aux_state_refuses_a_width_the_card_cannot_take(fused_ce):
    """The wrapper's loss state is where the width is checked, before the
    first step: a wrapper on a CUDA device (here a CPU wrapper told it is on
    one; the check raises before any tensor is made) refuses a width the
    kernels do not take, under either setting; on the CPU it runs."""
    cfg = LTHMModelConfig.from_dict(small_config(
        use_flash=False, fused_ce=fused_ce,
        product_tower=dict(small_config()["product_tower"], product_emb_dim=48),
    ))
    wrapper = LTHMModelWrapper(cfg, device="cpu")
    assert wrapper.init_aux_state().batch_idx.device.type == "cpu"
    wrapper.device = torch.device("cuda")
    with pytest.raises(ValueError, match="product_emb_dim 48"):
        wrapper.init_aux_state()


def test_rounded_library_is_named_by_the_source_it_includes(tmp_path):
    """``fused_ce_rounded.cu`` is ``fused_ce.cu`` built with ``CE_ROUNDED``
    defined: its library is its own, and its name follows an edit of the
    source it includes, so an edited ``fused_ce.cu`` is never served by a
    stale rounded library. (No build: the name alone.)"""
    from recommendations_tpu_torch.ops.cuda_build import CSRC, library_path

    for name in ("fused_ce.cu", "fused_ce_rounded.cu"):
        (tmp_path / name).write_bytes((CSRC / name).read_bytes())
    plain, rounded = library_path(tmp_path / "fused_ce.cu"), library_path(tmp_path / "fused_ce_rounded.cu")
    assert plain != rounded
    assert (tfc.CE_FWD.source.name, tfc.CE_FWD_ROUNDED.source.name) == ("fused_ce.cu", "fused_ce_rounded.cu")
    with open(tmp_path / "fused_ce.cu", "a") as f:
        f.write("\n// an edit\n")
    assert library_path(tmp_path / "fused_ce_rounded.cu") != rounded
    assert library_path(tmp_path / "fused_ce.cu") != plain
