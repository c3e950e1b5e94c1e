"""The port's ring attention (``parallel/ring_attention.py``) and its
sequence-parallel stack on gloo worker processes against the JAX package's
on its virtual CPU mesh of the same shape (4 devices, data x model): rings
of 2 and 4, causal and not, the relative-position bias with its table's
gradient, padded MQA at a length the ring does not divide, and the stack
of ``tests/test_seq_parallel_stack.py``'s cases (MQA and MHA at T = 8 and
9, with the position bias at T = window), outputs and gradients (the
inputs', every parameter's). Float32 forwards within 2e-5, gradients
within 2e-4 (the stack's 5e-4, as its JAX test)."""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from recommendations_tpu.core.mesh import MeshConfig, build_mesh
from recommendations_tpu.nn.transformer import TransformerStack as JaxStack
from recommendations_tpu.parallel.ring_attention import ring_attention, ring_attention_padded
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.nn.transformer import TransformerStack
from torch_dist import start_workers

WORLD = 4
FWD_TOL = 2e-5
GRAD_TOL = 2e-4
STACK_TOL = 5e-4


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def _ring_case(ring, causal, bias=False, padded=False):
    if padded:  # tests/test_ring_attention.py::test_ring_bias_mqa_padded
        b, h, t, d, nk = 2, 4, 27, 8, 32
        return dict(model=ring, causal=True, q=_normal(1, (b, h, t, d)), k=_normal(2, (b, 1, t, d)),
                    v=_normal(3, (b, 1, t, d)), co=_normal(4, (b, h, t, d)), tab=_normal(5, (2 * nk + 1, h), 0.3),
                    nk=nk)
    b, h, t, d = 4, 2, 32, 16
    return dict(model=ring, causal=causal, q=_normal(11, (b, h, t, d)), k=_normal(12, (b, h, t, d)),
                v=_normal(13, (b, h, t, d)), co=_normal(14, (b, h, t, d)),
                tab=_normal(15, (2 * t + 1, h), 0.5) if bias else None, nk=t if bias else 0)


RING = {
    **{f"ring{n}_{'causal' if c else 'full'}": _ring_case(n, c) for n in (2, 4) for c in (True, False)},
    "ring2_bias": _ring_case(2, True, bias=True),
    "ring4_bias": _ring_case(4, True, bias=True),
    "ring4_bias_mqa_padded": _ring_case(4, True, padded=True),
}
STACK = {  # name: (attn_type, T, position-bias window)
    **{f"stack_{a}_t{t}": (a, t, None) for a in ("multi_query", "multi_head") for t in (8, 9)},
    **{f"stack_bias_t{t}": ("multi_query", t, t) for t in (8, 9)},
}


def _jax_ring(c):
    mesh = build_mesh(MeshConfig(data=WORLD // c["model"], model=c["model"]), devices=jax.devices()[:WORLD])
    fn = ring_attention_padded if c["causal"] else ring_attention
    tab = None if c["tab"] is None else jnp.asarray(c["tab"])

    def f(q, k, v, tb):
        return fn(q, k, v, mesh, causal=c["causal"], bias_table=tb, nk=c["nk"])

    args = [jnp.asarray(c[x]) for x in ("q", "k", "v")]
    out = jax.jit(f)(*args, tab)
    co = jnp.asarray(c["co"])
    argnums = (0, 1, 2) if tab is None else (0, 1, 2, 3)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * co), argnums=argnums))(*args, tab)
    res = dict(zip(("dq", "dk", "dv", "dtab"), (np.asarray(g) for g in grads)))
    res["out"] = np.asarray(out)
    return res


def _stack_modules(attn_type, t, window):
    common = dict(num_layers=2, n_embd=16, n_head=2, attn_type=attn_type, is_causal=True, dropout=0.0,
                  attn_dropout=0.0, pos_bias_window=window)
    return JaxStack(**common), JaxStack(use_ring=True, mesh=build_mesh(
        MeshConfig(data=WORLD // 2, model=2), devices=jax.devices()[:WORLD]), **common)


def _jax_stack_params(name):
    """The stack's JAX parameters (random position-bias tables), input,
    cotangent, and the same weights as the port's state dict."""
    attn_type, t, window = STACK[name]
    dense, _ = _stack_modules(attn_type, t, window)
    x = _normal(20, (4, t, 16))
    params = dense.init(jax.random.PRNGKey(1), jnp.asarray(x))
    if window is not None:  # the tables start at zeros: randomize them
        def randomize(path, leaf):
            if "pos_bias" in jax.tree_util.keystr(path):
                return jnp.asarray(_normal(zlib.crc32(jax.tree_util.keystr(path).encode()), leaf.shape, 0.5))
            return leaf
        params = jax.tree_util.tree_map_with_path(randomize, params)
    port = TransformerStack(2, 16, 2, torch.Generator().manual_seed(0), attn_type=attn_type, is_causal=True,
                            pos_bias_window=window)
    state = {k: v.numpy() for k, v in state_dict_from_jax(_to_np(params), port).items()}
    return {"params": params, "state": state, "x": x, "cot": _normal(21, (4, t, 16)), "port": port}


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_stack(name, c):
    """JAX's ring stack (and its dense stack, which it equals) on
    ``_jax_stack_params``'s: output and gradients."""
    dense, ring = _stack_modules(*STACK[name])
    params, x, cot = c["params"], jnp.asarray(c["x"]), c["cot"]
    out = jax.jit(lambda p, a: ring.apply(p, a))(params, x)
    gp, gx = jax.jit(jax.grad(lambda p, a: jnp.sum(ring.apply(p, a) * cot), argnums=(0, 1)))(params, x)
    grads = {k: v.numpy() for k, v in state_dict_from_jax({"params": _to_np(gp["params"])}, c["port"]).items()}
    return {"out": np.asarray(out), "dx": np.asarray(gx), "grads": grads,
            "dense_out": np.asarray(dense.apply(params, x))}


@pytest.fixture(scope="module")
def results():
    stacks = {name: _jax_stack_params(name) for name in STACK}
    jobs = [(name, "ring", c) for name, c in RING.items()]
    jobs += [(name, "seq_stack", dict(state=s["state"], x=s["x"], cot=s["cot"], attn_type=STACK[name][0],
                                      window=STACK[name][2])) for name, s in stacks.items()]
    workers = start_workers(jobs, WORLD, timeout=150)
    want = {name: _jax_ring(c) for name, c in RING.items()}
    want.update({name: _jax_stack(name, c) for name, c in stacks.items()})
    ranks = workers.results()
    got = {}
    for name in [*RING, *STACK]:
        model = RING[name]["model"] if name in RING else 2
        res = [r[name] for r in ranks]
        by = {(x["coords"]["data"], x["coords"]["model"]): x for x in res}
        data = WORLD // model
        keys = ("out", "dq", "dk", "dv") if name in RING else ("out", "dx")
        g = {}
        for key in keys:
            for d in range(data):  # replicated over the ring
                for m in range(1, model):
                    np.testing.assert_allclose(by[(d, m)][key], by[(d, 0)][key], rtol=0, atol=1e-6)
            g[key] = np.concatenate([by[(d, 0)][key] for d in range(data)])
        if name in RING and RING[name]["tab"] is not None:
            g["dtab"] = sum(by[(d, 0)]["dtab"] for d in range(data))  # each data shard's rows
        if name in STACK:  # each rank's part of the parameters' gradients
            g["grads"] = {k: sum(x["grads"][k] for x in res) for k in res[0]["grads"]}
        got[name] = g
    return got, want


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_attention_matches_jax(results, name):
    got, want = results
    np.testing.assert_allclose(got[name]["out"], want[name]["out"], rtol=FWD_TOL, atol=FWD_TOL)
    for key in ("dq", "dk", "dv", "dtab"):
        if key in want[name]:
            np.testing.assert_allclose(got[name][key], want[name][key], rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=key)


@pytest.mark.parametrize("name", sorted(STACK))
def test_sequence_parallel_stack_matches_jax(results, name):
    got, want = results
    np.testing.assert_allclose(got[name]["out"], want[name]["out"], rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got[name]["out"], want[name]["dense_out"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got[name]["dx"], want[name]["dx"], rtol=STACK_TOL, atol=5e-5)
    assert set(got[name]["grads"]) == set(want[name]["grads"])
    for k, v in want[name]["grads"].items():
        np.testing.assert_allclose(got[name]["grads"][k], v, rtol=STACK_TOL, atol=5e-5, err_msg=k)
    if STACK[name][2] is not None:
        assert sum("pos_bias" in k for k in want[name]["grads"]) == 2
