"""The port's trainable product-embedding table against the JAX package's, on
the CPU: the row-sparse updates of ``train/sparse_table.py`` (the fused
record and the lazy rows), ``rowwise_adam``, ``KShiftEmbedding`` with a
fused record and its tap gradient, the dense table gradient at bf16, the
table-optimizer dispatch, and two training steps of the small LTHM for each
trainable ``table_optimizer``.

Inputs come from numpy with a seed; weights and states go across through
``models/lthm/convert.py``. The JAX side of a training step runs op by op,
as in tests/test_torch_train.py."""

import copy
import logging
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommendations_tpu.config.trainer_config import ModelTrainConfig as JaxTrainConfig
from recommendations_tpu.models.lthm import loss as jloss
from recommendations_tpu.models.lthm.config import LTHMModelConfig as JaxConfig
from recommendations_tpu.models.lthm.wrapper import LTHMModelWrapper as JaxWrapper
from recommendations_tpu.nn import embeddings as jemb
from recommendations_tpu.train import sparse_table as jst
from recommendations_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from recommendations_tpu.train.optimizers import rowwise_adam as jax_rowwise_adam
from recommendations_tpu.train.train_state import TrainState as JaxTrainState
from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
from recommendations_tpu_torch.models.lthm import convert
from recommendations_tpu_torch.models.lthm import loss as tloss
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import TABLE_PARAM, LTHMModelWrapper
from recommendations_tpu_torch.nn import embeddings as temb
from recommendations_tpu_torch.train import sparse_table as tst
from recommendations_tpu_torch.train.optimizers import RowwiseAdam
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState
from tests.test_torch_train import (
    GRAD_TOL,
    TOL,
    _check_metrics,
    _offsets,
    small_batch,
    small_config,
)

torch.set_num_threads(1)

ATOL, RTOL = 1e-6, 1e-5  # the row-sparse updates: float32 sums in another order


def _t(x):
    return torch.from_numpy(np.array(x))


# -- the row-sparse updates ------------------------------------------------------


def _sparse_case(case):
    """A record of 64 rows (d = 8), 40 (row, gradient) pairs with duplicate
    ids, rows whose every gradient is zero, and for ``nan`` a NaN gradient."""
    rs = np.random.RandomState(7)
    v, d, m = 64, 8, 40
    record = np.zeros((v, tst.RECORD_LANES), np.float32)
    record[:, :d] = rs.randn(v, d)
    record[:, d:2 * d] = 0.01 * rs.randn(v, d)
    record[:, 2 * d] = np.abs(0.001 * rs.randn(v))
    idx = rs.randint(0, 24, size=m).astype(np.int64)  # 24 distinct rows at most: duplicates
    grads = rs.randn(m, d).astype(np.float32)
    grads[idx == 3] = 0.0  # a row the loss never saw
    grads[idx == 5] = 0.0
    if case == "nan":
        grads[np.flatnonzero(idx == idx[0])[0], 2] = np.nan
    return record, idx, grads


@pytest.mark.parametrize("case", ["plain", "nan"])
def test_sparse_fused_adam_update_matches_jax(case):
    """Two steps from the same record, ids and gradients: the record within
    1e-6 + 1e-5 relative, the count and rows_nan equal, the rows written the
    same (untouched and zero-gradient rows bit for bit as they were)."""
    record, idx, grads = _sparse_case(case)
    jrec, jstate = jnp.asarray(record), jst.FusedTableState(count=jnp.zeros((), jnp.int32))
    trec, tstate = _t(record), tst.FusedTableState(count=torch.zeros((), dtype=torch.int32))
    for step in range(2):
        g = grads * (step + 1)
        jrec, jstate, jnan = jst.sparse_fused_adam_update(
            jrec, jnp.asarray(idx), jnp.asarray(g), jstate, learning_rate=1e-2, b1=0.9, b2=0.95)
        tstate, tnan = tst.sparse_fused_adam_update(
            trec, _t(idx), _t(g), tstate, learning_rate=1e-2, b1=0.9, b2=0.95)
        np.testing.assert_allclose(trec.numpy(), np.asarray(jrec), rtol=RTOL, atol=ATOL)
        assert int(tstate.count) == int(jstate.count) == step + 1
        assert bool(tnan) == bool(jnan) == (case == "nan")
    moved = np.flatnonzero((trec.numpy() != record).any(axis=1))
    jmoved = np.flatnonzero((np.asarray(jrec) != record).any(axis=1))
    np.testing.assert_array_equal(moved, jmoved)
    assert 3 not in moved and 5 not in moved and moved.max() < 24


@pytest.mark.parametrize("capacity", [1000, 7])
@pytest.mark.parametrize("case", ["plain", "nan"])
def test_lazy_rowwise_adam_update_matches_jax(capacity, case):
    """Two steps on a (64, 8) table whose gradient touches some rows (zero
    rows skipped); at capacity 7 only the first 7 touched rows in index
    order are applied, as ``jnp.nonzero(size=7)`` keeps them. Table and
    moments within 1e-6 + 1e-5 relative, the count and the rows equal."""
    rs = np.random.RandomState(8)
    n, d = 64, 8
    table = rs.randn(n, d).astype(np.float32)
    grad = rs.randn(n, d).astype(np.float32)
    grad[rs.rand(n) < 0.6] = 0.0
    grad[10, 3] = 0.0  # one zero entry in a touched row
    if case == "nan":
        grad[np.flatnonzero(grad.any(axis=1))[2], 1] = np.nan
    jtab, jstate = jnp.asarray(table), jst.init_lazy_row_state(jnp.asarray(table))
    ttab = _t(table)
    tstate = tst.init_lazy_row_state(ttab)
    for step in range(2):
        jtab, jstate = jst.lazy_rowwise_adam_update(
            jtab, jnp.asarray(grad), jstate, learning_rate=1e-2, capacity=capacity, b1=0.9, b2=0.95)
        tstate = tst.lazy_rowwise_adam_update(
            ttab, _t(grad), tstate, learning_rate=1e-2, capacity=capacity, b1=0.9, b2=0.95)
        np.testing.assert_allclose(ttab.numpy(), np.asarray(jtab), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tstate.m.numpy(), np.asarray(jstate.m), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tstate.v.numpy(), np.asarray(jstate.v), rtol=RTOL, atol=ATOL)
        assert int(tstate.count) == int(jstate.count) == step + 1
    moved = np.flatnonzero((ttab.numpy() != table).any(axis=1))
    np.testing.assert_array_equal(moved, np.flatnonzero((np.asarray(jtab) != table).any(axis=1)))
    touched = np.flatnonzero(grad.any(axis=1))
    np.testing.assert_array_equal(moved, touched[:capacity])


def test_rowwise_adam_matches_optax():
    """RowwiseAdam against the JAX package's optax transform over 3 steps of
    the same gradients, within 1e-6; the state too."""
    rs = np.random.RandomState(9)
    p0 = rs.randn(50, 16).astype(np.float32)
    tx = jax_rowwise_adam(1e-2, b1=0.9, b2=0.95)
    jp, jstate = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(_t(p0))
    opt = RowwiseAdam([tp], lr=1e-2, betas=(0.9, 0.95))
    for _ in range(3):
        g = rs.randn(50, 16).astype(np.float32)
        g[rs.rand(50) < 0.3] = 0.0
        upd, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = jp + upd
        tp.grad = _t(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    st = opt.state[tp]
    np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(jstate["mu"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(jstate["nu"]), rtol=0, atol=1e-6)
    assert int(st["step"]) == int(jstate["count"]) == 3


def test_fused_record_init_layout():
    """The record's table lanes are N(0, 1) from the generator, the rest 0."""
    rec = tst.fused_record_init(3000, 32, torch.Generator().manual_seed(0))
    assert rec.shape == (3000, 128) and rec.dtype == torch.float32
    assert not rec[:, 32:].any()
    table = tst.fused_record_table(rec, 32)
    assert abs(table.mean().item()) < 0.02 and abs(table.std().item() - 1) < 0.02
    with pytest.raises(ValueError, match="2\\*d\\+1"):
        tst.fused_record_init(4, 64, torch.Generator())


# -- the lookup --------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [False, True])
def test_kshift_fused_record_forward_and_tap_gradient_match_jax(normalize):
    """KShiftEmbedding with a fused record at bf16: the forward within
    float32 rounding (as test_kshift_embedding), and the gradient of the tap
    (the gathered rows' gradient, bf16) within one bf16 ulp of its largest
    element."""
    rs = np.random.RandomState(4)
    ids = rs.randint(-(2**62), 2**62, size=(3, 11)).astype(np.int64)
    ids[0, -2:] = 0
    w = rs.randn(3, 11, 16).astype(np.float32)
    jm = jemb.KShiftEmbedding(5000, 16, num_shifts=8, normalize_output=normalize,
                              compute_dtype=jnp.bfloat16, fused_record=True)
    vs = jm.init(jax.random.PRNGKey(3), jnp.asarray(ids))
    tap0 = jnp.zeros((3, 11, 8, 16), jnp.bfloat16)

    def f(tap):
        return jnp.sum(jm.apply(vs, jnp.asarray(ids), tap=tap) * w)

    want = np.asarray(jm.apply(vs, jnp.asarray(ids), tap=tap0))
    want_tap = np.asarray(jax.grad(f)(tap0)).astype(np.float32)

    tm = temb.KShiftEmbedding(5000, 16, torch.Generator(), num_shifts=8, normalize_output=normalize,
                              compute_dtype=torch.bfloat16, fused_record=True)
    tm.load_state_dict(convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, vs), tm))
    assert tm.embedding.shape == (5000, 128) and not tm.embedding.requires_grad
    tap = torch.zeros((3, 11, 8, 16), dtype=torch.bfloat16, requires_grad=True)
    out = tm(torch.from_numpy(ids), tap=tap)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=2e-6, atol=2e-6)
    got_tap = tap.grad.float().numpy()
    assert np.abs(got_tap - want_tap).max() <= 2**-8 * np.abs(want_tap).max()
    assert tm.embedding.grad is None
    # serving reads the record's table lanes without taps
    np.testing.assert_array_equal(tm(torch.from_numpy(ids)).detach().numpy(), out.detach().numpy())


def test_dense_table_gradient_sums_in_bf16_as_jax():
    """The dense table's gradient at bf16 compute: JAX casts the table before
    its gather, so a row's duplicate cotangents are summed in bf16 and
    converted once to f32; the port sums them in bf16 too. On a 7-row table
    read 8 times per id, every row repeats often. Held per row within the
    row's duplicate count of bf16 ulps of the row's largest value (the sum
    order may differ; on the CPU both sum in index order). The port sums in
    the order of occurrence on every device, so the card gives the same
    bits twice (tests/test_torch_table_cuda.py)."""
    rs = np.random.RandomState(5)
    ids = rs.randint(-(2**62), 2**62, size=(4, 30)).astype(np.int64)
    w = rs.randn(4, 30, 16).astype(np.float32)
    jm = jemb.KShiftEmbedding(7, 16, num_shifts=8, compute_dtype=jnp.bfloat16)
    vs = jm.init(jax.random.PRNGKey(1), jnp.asarray(ids))

    def f(params):
        return jnp.sum(jm.apply({"params": params}, jnp.asarray(ids)) * w)

    want = np.asarray(jax.grad(f)(vs["params"])["embedding"])
    tm = temb.KShiftEmbedding(7, 16, torch.Generator(), num_shifts=8, compute_dtype=torch.bfloat16)
    tm.load_state_dict(convert.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, vs), tm))
    (tm(torch.from_numpy(ids)) * torch.from_numpy(w)).sum().backward()
    got = tm.embedding.grad.numpy()
    assert got.dtype == np.float32
    idx = temb.kshift_row_indices(torch.from_numpy(ids), 7, 8).numpy().reshape(-1)
    dups = np.bincount(idx, minlength=7)
    assert dups.min() > 50
    for row in range(7):
        scale = np.abs(want[row]).max()
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        err = np.abs(got[row] - want[row]).max()
        assert err <= dups[row] * ulp, f"row {row}: {err} > {dups[row]} ulps of {ulp}"
    assert np.isfinite(got).all()


# -- the dispatch ------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 1_000_000, 1_999_999, 2_000_000, 4_999_999, 5_000_000, 10_000_000])
@pytest.mark.parametrize("detach", [True, False])
@pytest.mark.parametrize("shard", [False, True])
def test_auto_table_optimizer_resolves_as_jax(rows, detach, shard):
    """``auto`` resolves as the JAX package resolves it at every V; both
    packages refuse lazy_rowwise_adam from 5M rows with the same text."""
    d = small_config(False, table_optimizer="auto", shard_embedding_rows=shard)
    d["product_tower"]["detach_item_tower"] = detach
    d["product_tower"]["latent_model_config"]["vocab_size_latent"] = rows
    jc, tc = JaxConfig(**copy.deepcopy(d)), LTHMModelConfig.from_dict(copy.deepcopy(d))
    assert tc.resolved_table_optimizer() == jc.resolved_table_optimizer()
    assert tc.uses_fused_table() == jc.uses_fused_table()
    d["table_optimizer"] = "lazy_rowwise_adam"
    if rows < 5_000_000:
        LTHMModelConfig.from_dict(copy.deepcopy(d))
        return
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**copy.deepcopy(d))
    with pytest.raises(ValueError) as terr:
        LTHMModelConfig.from_dict(copy.deepcopy(d))
    assert str(terr.value) in str(jerr.value)


def test_sparse_fused_warnings_as_jax(caplog):
    """The JAX wrapper's warnings: sparse_fused_adam below 2M rows."""
    d = small_config(False, table_optimizer="sparse_fused_adam")
    messages = {}
    for pkg, build in (("jax", lambda: JaxWrapper(JaxConfig(**copy.deepcopy(d)))),
                       ("torch", lambda: LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)),
                                                          device="cpu"))):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            build()
        messages[pkg] = [r.getMessage() for r in caplog.records if "sparse_fused_adam" in r.getMessage()]
    assert len(messages["torch"]) == 1 and messages["torch"] == messages["jax"]


def test_param_labels_and_groups_per_table_optimizer():
    """The table is its own group but under adamw, where it joins the main
    group; the frozen, lazy and fused tables are not stepped by the
    optimizer; rowwise_adam steps the table with RowwiseAdam."""
    seen = {}
    for t in ("frozen", "adamw", "rowwise_adam", "lazy_rowwise_adam", "sparse_fused_adam"):
        d = small_config(False, table_optimizer=t)
        d["product_tower"]["detach_item_tower"] = False
        jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
        tw = LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
        state = TrainState.create(tw)
        label = tw.param_labels()[TABLE_PARAM]
        jlabel = "EMB_TABLE" if jw._uses_rowwise_table() else "USE_OPTIM"
        assert label == jlabel, t
        stepped = any(p is tw.module.product_emb_module.embedding for p in state.optimizer.params())
        seen[t] = (label, stepped, type(state.optimizer.table).__name__,
                   (jw.uses_sparse_taps(), jw.uses_lazy_table()) == (tw.uses_sparse_taps(), tw.uses_lazy_table()))
    assert seen == {
        "frozen": ("EMB_TABLE", False, "NoneType", True),
        "adamw": ("USE_OPTIM", True, "NoneType", True),
        "rowwise_adam": ("EMB_TABLE", True, "RowwiseAdam", True),
        "lazy_rowwise_adam": ("EMB_TABLE", False, "NoneType", True),
        "sparse_fused_adam": ("EMB_TABLE", False, "NoneType", True),
    }


# -- two training steps ------------------------------------------------------------


_JAX = {}


def _table_pair(d):
    """(JAX wrapper, variables, port wrapper with the same weights)."""
    key = repr(d)
    if key not in _JAX:
        jw = JaxWrapper(JaxConfig(**copy.deepcopy(d)))
        batch = {k: jnp.asarray(v) for k, v in small_batch().items()}
        _JAX[key] = jw, jw.init_variables(jax.random.PRNGKey(0), batch)
    jw, vs = _JAX[key]
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(copy.deepcopy(d)), device="cpu")
    tw.load_jax_variables(jax.tree_util.tree_map(np.asarray, vs))
    return jw, vs, tw


def _jax_step(jw, optimizer, state, batch):
    """``train_step`` of recommendations_tpu/train/strategy.py:142-232 with
    its taps and lazy branches, run op by op."""
    rng, sub = jax.random.split(state.rng)
    use_taps = jw.uses_sparse_taps()
    if use_taps:
        def loss_fn(p, taps):
            return jw.loss_and_metrics(p, state.constants, state.aux, batch, sub, True, taps=taps)

        (loss, (metrics, new_aux)), (grads, tap_grads) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(state.params, jw.make_taps(batch))
    else:
        def loss_fn(p):
            return jw.loss_and_metrics(p, state.constants, state.aux, batch, sub, True)

        (loss, (metrics, new_aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(state.params)
        tap_grads = None
    updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
    new_params = jax.tree_util.tree_map(lambda p, u: p + u, state.params, updates)
    table_state, rows_nan = state.table_state, None
    if table_state is not None:
        if use_taps:
            new_params, table_state, rows_nan = jw.apply_sparse_table_update(
                new_params, tap_grads, state.table_state, batch)
        else:
            new_params, table_state = jw.apply_lazy_table_update(new_params, grads, state.table_state, batch)
    metrics = dict(metrics)
    gsq = sum(jnp.sum(jnp.square(g)) for g in jax.tree_util.tree_leaves(grads))
    if use_taps:
        gsq = gsq + sum(jnp.sum(jnp.square(g.astype(jnp.float32))) for g in jax.tree_util.tree_leaves(tap_grads))
    metrics["grad_norm"] = gsq ** 0.5
    nan_tree = jw.nan_check_params(new_params)
    params_nan = jnp.any(jnp.stack([jnp.isnan(x).any() for x in jax.tree_util.tree_leaves(nan_tree)]))
    if rows_nan is not None:
        params_nan = params_nan | rows_nan
    metrics["params_nan"] = params_nan
    new_state = JaxTrainState(params=new_params, constants=state.constants, opt_state=new_opt, aux=new_aux,
                              step=state.step + 1, rng=rng, table_state=table_state)
    return new_state, loss, metrics, sub


def _leaves_of(tree, cls):
    return [x for x in jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, cls)) if isinstance(x, cls)]


def _load_jax_state(jstate, tw, tstate):
    """The JAX train state after a step -> the port's: variables (the record
    or the table among them), aux, AdamW moments, rowwise_adam's state and
    the lazy or fused table state."""
    np_tree = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
    tw.load_jax_variables(np_tree({"params": jstate.params, "constants": jstate.constants}))
    tstate.aux = convert.aux_state_from_jax(np_tree(jstate.aux))
    multi = _leaves_of(jstate.opt_state, optax.MultiTransformState)
    (adam,) = _leaves_of(multi[0].inner_states["USE_OPTIM"] if multi else jstate.opt_state, optax.ScaleByAdamState)
    convert.adamw_state_from_jax(np_tree(adam.mu), np_tree(adam.nu), adam.count, tw.module,
                                 tstate.optimizer.inner)
    if tstate.optimizer.table is not None:
        convert.rowwise_adam_state_from_jax(np_tree(multi[0].inner_states["EMB_TABLE"].inner_state), tw.module,
                                            tstate.optimizer.table)
    if jstate.table_state is not None:
        tstate.table_state = convert.table_state_from_jax(np_tree(jstate.table_state),
                                                          tw.module.product_emb_module.embedding)


def _norm_rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_ce_operands(jw, jstate, jbatch):
    """The bf16 (q16, c16) pairs JAX's loss hands its CE at this state, in
    call order (a forward with the rng the next step draws)."""
    _, sub = jax.random.split(jstate.rng)
    rec, orig = [], jloss._ce_rows

    def recording(q16, c16, *args, **kw):
        rec.append(tuple(torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (q16, c16)))
        return orig(q16, c16, *args, **kw)

    taps = {"taps": jw.make_taps(jbatch)} if jw.uses_sparse_taps() else {}
    with mock.patch.object(jloss, "_ce_rows", recording):
        jw.loss_and_metrics(jstate.params, jstate.constants, jstate.aux, jbatch, sub, True, **taps)
    return rec


def _substituting_ce(rec, flips):
    """The port's ``_ce_rows`` with its bf16 operands replaced by JAX's
    (``rec``) in value, not in gradient; appends to ``flips`` how many
    elements differed, each at most one bf16 step from JAX's."""
    orig = tloss._ce_rows

    def substituted(q16, c16, *args, **kw):
        jq, jc = rec[len(flips)]
        n = 0
        for got, want in ((q16, jq), (c16, jc)):
            steps = got.detach().view(torch.int16).int() - want.view(torch.int16).int()
            assert int(steps.abs().max()) <= 1, "a CE operand differs by more than one bf16 rounding"
            n += int((steps != 0).sum())
        flips.append(n)
        return orig(q16 + (jq - q16).detach(), c16 + (jc - c16).detach(), *args, **kw)

    return substituted


def _two_steps_against_jax(table_optimizer, clip, jax_ce_operands=False):
    """Two f32 steps of the small LTHM with detach_item_tower false: step 1
    from one initial state, step 2 from JAX's state after step 1 converted
    into the port. The loss within 1e-4; grad_norm and each parameter's
    update (the table or record included) within 2e-4 norm-relative; the
    table's optimizer state likewise, its count equal. With
    ``jax_ce_operands`` the port's CE reads JAX's bf16 operands; returns the
    number of operands that differed at each step."""
    d = small_config(False, "float32", beta=0.5, mini_batch=3, table_optimizer=table_optimizer)
    d["product_tower"]["detach_item_tower"] = False
    jw, vs, tw = _table_pair(d)
    jbatch = {k: jnp.asarray(v) for k, v in small_batch().items()}
    jopt = jax_build_optimizer(jw, JaxTrainConfig(**clip), vs["params"])
    jstate = JaxTrainState.create(vs["params"], vs.get("constants", {}), jopt.init(vs["params"]), jw.init_aux_state(),
                                  jax.random.PRNGKey(1), table_state=jw.init_table_state(vs["params"]))
    tstate = TrainState.create(tw, ModelTrainConfig(**clip))
    flips_per_step = []
    for step in range(2):
        if step == 1:
            _load_jax_state(jstate, tw, tstate)
        flips = []
        ce = _substituting_ce(_jax_ce_operands(jw, jstate, jbatch), flips) if jax_ce_operands else tloss._ce_rows
        before = {name: p.detach().clone() for name, p in tw.module.named_parameters()}
        jstate, jl, jm, sub = _jax_step(jw, jopt, jstate, jbatch)
        with mock.patch.object(tloss, "_ce_rows", ce):
            tl, tm = train_step(tstate, small_batch(), offsets=_offsets(sub, d["lookahead"]))
        flips_per_step.append(sum(flips))
        assert abs(float(tl) - float(jl)) <= TOL, step
        _check_metrics(tm, {k: v for k, v in jm.items() if k not in ("grad_norm", "params_nan")})
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= GRAD_TOL * float(jm["grad_norm"])
        assert float(tm["params_nan"]) == float(jm["params_nan"]) == 0.0
        want = convert.state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, {"params": jstate.params, "constants": jstate.constants}), tw.module
        )
        for name, p in tw.module.named_parameters():
            got_step = (p.detach() - before[name]).numpy()
            want_step = (want[name] - before[name]).numpy()
            err = _norm_rel(got_step, want_step)
            assert err <= GRAD_TOL, f"{name}, step {step + 1}: update error {err:.3e}"
        table_step = (tw.module.product_emb_module.embedding.detach() - before[TABLE_PARAM]).numpy()
        assert np.any(table_step), "the table did not train"
        if table_optimizer == "rowwise_adam":
            (multi,) = _leaves_of(jstate.opt_state, optax.MultiTransformState)
            jrow = multi.inner_states["EMB_TABLE"].inner_state
            st = tstate.optimizer.table.state[tw.module.product_emb_module.embedding]
            assert int(st["step"]) == int(jrow["count"]) == step + 1
            for key, jkey in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                jval = np.asarray(jrow[jkey]["product_emb_module"]["embedding"])
                assert _norm_rel(st[key].numpy(), jval) <= GRAD_TOL, key
        if table_optimizer == "lazy_rowwise_adam":
            assert int(tstate.table_state.count) == int(jstate.table_state.count) == step + 1
            assert _norm_rel(tstate.table_state.m.numpy(), np.asarray(jstate.table_state.m)) <= GRAD_TOL
            assert _norm_rel(tstate.table_state.v.numpy(), np.asarray(jstate.table_state.v)) <= GRAD_TOL
            untouched = ~np.asarray(jstate.table_state.v).any(axis=1)
            assert not table_step[untouched].any()
        if table_optimizer == "sparse_fused_adam":
            assert int(tstate.table_state.count) == int(jstate.table_state.count) == step + 1
            untouched = ~np.asarray(jstate.params["product_emb_module"]["embedding"])[:, 32:33].any(axis=1)
            assert not table_step[untouched].any()
    return flips_per_step


TABLE_OPTIMIZERS = ["rowwise_adam", "lazy_rowwise_adam", "sparse_fused_adam", "adamw"]


@pytest.mark.parametrize("clip", [{}, {"gradient_clip_norm": 1.0}])
@pytest.mark.parametrize("table_optimizer", TABLE_OPTIMIZERS)
def test_two_train_steps_match_jax_with_a_trainable_table(table_optimizer, clip):
    """Two steps against JAX's (``_two_steps_against_jax``), unclipped and at
    clip norm 1.0: the gradient norm (about 7.5, then 5.9) is clipped, the
    table's gradient counts in the norm, and the lazy and fused updates read
    it unclipped. Clip norm 0.5 is the next test's."""
    _two_steps_against_jax(table_optimizer, clip)


@pytest.mark.parametrize("table_optimizer", TABLE_OPTIMIZERS)
def test_two_train_steps_at_clip_half_match_jax_given_its_bf16_ce_operands(table_optimizer):
    """The same two steps at clip norm 0.5, with the port's CE reading JAX's
    bf16 operands. The CE rounds the L2-normalized queries and candidates
    to bf16 (at f32 too, as the JAX package's ``_head_loss`` does), a step
    function: where an element lies within float32 rounding of a bf16
    rounding edge, the port's last bits and JAX's round it to neighbouring
    bf16 values. At clip 0.5 the step-2 state of the lazy and fused runs
    has 10-12 such elements of 18432, which move the loss by up to 1.1e-4
    and AdamW's updates by up to 9e-4 (JAX's own rowwise and lazy paths,
    whose tables differ by 3.5e-6, give losses 7e-5 apart the same way).
    So this test takes JAX's operands in value, asserts that each of the
    port's lies at most one bf16 step from JAX's, and holds everything else
    to the full tolerances."""
    flips = _two_steps_against_jax(table_optimizer, {"gradient_clip_norm": 0.5}, jax_ce_operands=True)
    assert all(n <= 32 for n in flips), flips


def test_rowwise_state_converter_is_strict():
    d = small_config(False, table_optimizer="rowwise_adam")
    d["product_tower"]["detach_item_tower"] = False
    tw = LTHMModelWrapper(LTHMModelConfig.from_dict(d), device="cpu")
    state = TrainState.create(tw)
    table = tw.module.product_emb_module.embedding
    good = {"product_emb_module": {"embedding": np.zeros(tuple(table.shape), np.float32)}}
    bad_nu = {"product_emb_module": {"embedding": np.zeros(tuple(table.shape), np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        convert.rowwise_adam_state_from_jax({"mu": good, "nu": bad_nu, "count": 1}, tw.module, state.optimizer.table)
    nu = {"product_emb_module": {"embedding": np.zeros((table.shape[0], 1), np.float32)}}
    convert.rowwise_adam_state_from_jax({"mu": good, "nu": nu, "count": 1}, tw.module, state.optimizer.table)
    assert int(state.optimizer.table.state[table]["step"]) == 1
    with pytest.raises(ValueError, match="lazy table state"):
        convert.table_state_from_jax(tst.LazyRowState(m=np.zeros((3, 2)), v=np.zeros((3, 1)), count=0), table)
