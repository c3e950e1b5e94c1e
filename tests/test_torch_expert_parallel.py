"""Expert parallelism in the port: ``MoELinear`` with its expert stacks
split over an ``expert`` group of 2 gloo worker processes. The forward is
held to the JAX package's ``MoELinear``, the backward to the port's
one-process ``MoELinear``, and the MoE LTHM of
``tests/test_expert_parallel.py`` bound to the expert mesh to the port's
one-process LTHM; ``tests/test_torch_moe.py`` holds both one-process
modules to JAX (the JAX package cannot take the backward of expert-sharded
parameters on its CPU mesh). Float32 forwards within 2e-5, gradients
within 2e-4. Then the collectives' values and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendations_tpu.nn.transformer import MoELinear as JaxMoE
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.convert import state_dict_from_jax
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.nn.transformer import MoELinear
from torch_dist import start_workers

WORLD = 2
FWD_TOL = 2e-5
GRAD_TOL = 2e-4

# name: (in, out, proj, experts, top_k, gate_sizes)
MOE = {
    "dense_gate": (12, 24, 16, 4, None, ()),
    "top2_gate_mlp": (12, 24, 16, 4, 2, (8,)),
    "top1_8_experts": (16, 8, 8, 8, 1, ()),
}


def _normal(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _moe_case(name):
    d_in, d_out, proj, e, top_k, gates = MOE[name]
    jm = JaxMoE(out_features=d_out, proj_features=proj, num_experts=e, top_k=top_k, gate_sizes=gates)
    x = _normal(0, (8, 5, d_in))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    port = MoELinear(d_in, d_out, proj, e, torch.Generator().manual_seed(0), top_k=top_k, gate_sizes=gates)
    state = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params), port)
    port.load_state_dict(state)
    cot = _normal(2, want.shape)
    xt = torch.tensor(x, requires_grad=True)
    (port(xt) * torch.from_numpy(cot)).sum().backward()
    one = {"dx": xt.grad.numpy(), "grads": {k: p.grad.numpy() for k, p in port.named_parameters()}}
    job = dict(state={k: v.numpy() for k, v in state.items()}, x=x, cot=cot, out_features=d_out,
               proj_features=proj, num_experts=e, top_k=top_k, gate_sizes=gates)
    return job, {"out": want, **one}


def _lthm_config():
    """tests/test_expert_parallel.py's MoE LTHM (float32)."""
    return dict(
        features={"defaults": {}},
        transformer_config=dict(
            rotator_config={"num_experts": 4, "proj_features": 16, "ff_mult_factor": 2},
            is_causal=True, num_layers=1,
            attn_config=dict(n_head=2, n_embd=32, attn_type="multi_query", dropout=0.0, attn_dropout=0.0,
                             bias=False),
        ),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=32, product_emb_dim=16, norm_bins=4,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 8}],
            latent_model_config={"vocab_size_latent": 1024, "num_shifts_latent": 4, "normalize_embedding": True},
        ),
        log_q_config={"num_buckets": 1024, "hash_offsets": [0]},
        lookahead=[0, 2], context_width=8, train_mini_batch_size=-1, compute_dtype="float32",
    )


def _lthm_case():
    rs = np.random.RandomState(0)
    ids = rs.randint(-(2**62), 2**62, size=(8, 12)).astype(np.int64)
    ids[:, -2:] = 0
    batch = {"product_ids": ids, "labels": rs.randint(0, 4, size=(8, 12)).astype(np.float32),
             "timestamps": rs.randint(1_600_000_000, 1_700_000_000, size=(8, 12)).astype(np.float32)}
    offsets = np.asarray([0, 1])
    job = dict(config=_lthm_config(), batch=batch, offsets=offsets)

    def want():  # the port's one-process validation loss on the same weights
        w = LTHMModelWrapper(LTHMModelConfig.from_dict(_lthm_config()), device="cpu")
        loss, metrics, _ = w.loss_and_metrics(batch, w.init_aux_state(), False, offsets=offsets)
        return {"loss": float(loss), "val_loss": float(metrics["val_loss"])}

    return job, want


@pytest.fixture(scope="module")
def results():
    cases = {name: _moe_case(name) for name in MOE}
    lthm_job, lthm_want = _lthm_case()
    jobs = [(name, "moe", job) for name, (job, _) in cases.items()] + [("lthm", "moe_lthm", lthm_job)]
    jobs.append(("collectives", "collectives", {}))
    workers = start_workers(jobs, WORLD, timeout=120)
    want = {name: w for name, (_, w) in cases.items()}
    want["lthm"] = lthm_want()
    ranks = workers.results()
    return ranks, want


@pytest.mark.parametrize("name", sorted(MOE))
def test_expert_parallel_forward_matches_jax(results, name):
    ranks, want = results
    for r in ranks:  # the mix is summed over the group: the same on each rank
        np.testing.assert_allclose(r[name]["out"], want[name]["out"], rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("name", sorted(MOE))
def test_expert_parallel_backward_matches_one_process(results, name):
    """Each rank's expert stacks' gradients are its experts' block of the
    one process's; the gates' and the input's are whole on every rank."""
    ranks, want = results
    order = sorted(ranks, key=lambda r: r[name]["coords"]["expert"])
    for key, g in want[name]["grads"].items():
        if key in ("w1", "b1", "w2", "b2"):
            got = np.concatenate([r[name]["grads"][key] for r in order])
            np.testing.assert_allclose(got, g, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=key)
        else:
            for r in ranks:
                np.testing.assert_allclose(r[name]["grads"][key], g, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=key)
    for r in ranks:
        np.testing.assert_allclose(r[name]["dx"], want[name]["dx"], rtol=GRAD_TOL, atol=GRAD_TOL)


def test_moe_lthm_loss_with_sharded_experts_matches_one_process(results):
    ranks, want = results
    for r in ranks:
        assert r["lthm"]["shapes"]["query_tower.transformer.block_0.moe_fc.w1"][0] == 2  # 4 experts / 2 ranks
        np.testing.assert_allclose(r["lthm"]["loss"], want["lthm"]["loss"], rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(r["lthm"]["val_loss"], want["lthm"]["val_loss"], rtol=FWD_TOL, atol=FWD_TOL)


def test_collectives_values_and_gradients(results):
    """``parallel/collectives.py`` over the 2 ranks: the tiled gather and
    exchange, the ring shift both ways, and the gradients JAX's transposes
    give: psum's identity, copy_to_group's sum over the group, all_gather's
    own block, ppermute's shift back."""
    ranks, _ = results
    n = len(ranks)
    xs = [np.arange(2 * n, dtype=np.float32) + 10 * r for r in range(n)]
    w = np.arange(1, 2 * n + 1, dtype=np.float32)
    for r, res in enumerate(ranks):
        c = res["collectives"]
        np.testing.assert_array_equal(c["all_gather"], np.concatenate(xs))
        np.testing.assert_array_equal(c["all_to_all"], np.concatenate([x[2 * r:2 * r + 2] for x in xs]))
        np.testing.assert_array_equal(c["ppermute"], xs[(r - 1) % n])
        np.testing.assert_array_equal(c["ppermute_back"], xs[(r + 1) % n])
        np.testing.assert_array_equal(c["psum_grad"], w)
        np.testing.assert_array_equal(c["copy_grad"], w * sum(q + 1 for q in range(n)))
        np.testing.assert_array_equal(c["all_gather_grad"], np.arange(2 * n * n, dtype=np.float32)[2 * n * r:2 * n * (r + 1)])
        np.testing.assert_array_equal(c["ppermute_grad"], w * ((r + 1) % n + 1))
