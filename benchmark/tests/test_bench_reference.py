"""The plain reference against the port's plain path at a tiny size on the
CPU, in float32 (the LSH products too; the CE's operands stay bf16 in the
port), on the benchmark's weights: the forward, the serving vectors, and
two training steps' losses, the first gradients and the AdamW updates."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import checks
from benchmark.harness.traffic import make_pool
from benchmark.models import lthm as model
from benchmark.reference import lthm as ref
from benchmark.tests.helpers import TEST_CONFIG

SEED = 4_000_000_003


@pytest.fixture(scope="module")
def setup():
    config = json.loads(TEST_CONFIG.read_text())
    cfg = dict(config["model_config"], compute_dtype="float32")
    mix = json.loads((TEST_CONFIG.parent.parent / "traffic" / "train64.json").read_text())
    mix.update(users=8, pool=2, catalog=5000)
    pool = make_pool(mix, config["history_length"], cfg["context_width"], SEED)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in pool]
    weights = model.make_weights(cfg, SEED, "cpu")
    return cfg, config, batches, weights


def program(cfg, weights):
    wrapper = model.build_program(cfg, weights, "cpu")
    for m in wrapper.module.modules():
        if type(m).__name__ == "CosineVectorEmbedding":
            m.compute_dtype = torch.float32
    return wrapper


def test_bench_reference_forward_matches_the_port(setup):
    cfg, _, batches, weights = setup
    wrapper = program(cfg, weights)
    with torch.no_grad():
        got = wrapper.module(wrapper.format_inputs(batches[0]))
    want = ref.encode(cfg, weights, batches[0], ref.Precision("f32"), grad=False)
    for k in ("current_token_mask", "current_token_ids"):
        assert torch.equal(got[k], want[k])
    for k in ("current_token_emb", "next_token_emb"):
        assert torch.allclose(got[k], want[k], atol=2e-5, rtol=1e-5), k
    emb = model.serve_fn(wrapper)(batches[0])["user_emb"]
    assert torch.allclose(emb, model.reference_serve(cfg, weights, batches[0]), atol=2e-5)


def test_bench_reference_training_matches_the_port(setup):
    cfg, config, batches, weights = setup
    wrapper = program(cfg, weights)
    state = model.train_state(wrapper, config["train"], 77)
    step = model.train_step_fn()
    start = {n: p.detach().clone() for n, p in model.trained_params(state).items()}
    losses = []
    for i, b in enumerate(batches):
        losses.append(step(state, b)[0].item())
        if i == 0:
            grads = model.first_grad_norms(state)
    got = model.reference_train(cfg, weights, batches, 77)
    change = {n: (p.detach() - start[n]).norm().item() for n, p in model.trained_params(state).items()}
    numbers = checks.train_numbers({"losses": losses, "grad_norms": grads, "change_norms": change}, got)
    # the port's CE takes bf16 operands in any compute dtype (the reference
    # float32): about 1e-4 of the loss, 1e-3 of a leaf's gradient, and Adam's
    # first steps turn that into about 1% of a small leaf's change
    assert numbers["loss_gap"] < 5e-4 and numbers["grad_gap"] < 3e-3 and numbers["change_gap"] < 0.02, numbers


def test_bench_reference_offsets_follow_the_generator():
    gen = torch.Generator().manual_seed(5)
    offsets = ref.sample_offsets(gen, [0, 5, 6, 12, 24, 30])
    assert offsets[0] == 0 and all(a < b for a, b in zip(offsets, offsets[1:]))
    assert all(o <= hi for o, hi in zip(offsets, [0, 5, 6, 12, 24, 30]))


def test_bench_kshift_rows_unsigned():
    ids = torch.tensor([-1, 1, 2**62, -(2**63)], dtype=torch.int64)
    rows = ref.kshift_rows(ids, 1000, 3)
    for i, x in enumerate(ids.tolist()):
        u = x % 2**64
        for c in range(3):
            rot = ((u << c) | (u >> (64 - c))) % 2**64 if c else u
            assert rows[i, c].item() == rot % 1000
