"""The ranker, the MoE rotator and the sparse keep-sets on the card: the
ranker's forward and one step's gradients against the CPU's, one step from
one state the same bits twice (the QR tables' duplicate rows summed in a
fixed order); ``MoELinear`` in float32 against the CPU and a sparse MoE
block's backward the same bits twice.

These tests need an NVIDIA GPU and skip without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_ranker_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""

import numpy as np
import pytest
import torch

from recommendations_tpu_torch.models.ranker.config import RankerModelConfig
from recommendations_tpu_torch.models.ranker.wrapper import RankerModelWrapper
from recommendations_tpu_torch.nn import transformer as ttr
from recommendations_tpu_torch.tools.synth_data import make_ranking_log
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState

pytestmark = pytest.mark.cuda

RANKER = dict(
    emb_dim=32, tower_hidden=[128, 64], tower_dim=32, top_hidden=[128, 64], num_embeddings_default=2**20,
    weight_decay=1e-4,
    tasks=[{"name": "click", "kind": "numerical", "num_labels": 1, "weight": 1.0},
           {"name": "conversion", "kind": "numerical", "num_labels": 1, "weight": 0.5}],
    features={
        "defaults": {"categorical_features": {"default_dtype": "string", "transform_value_to_lowercase": False,
                                              "value_to_number_mapper": {"kind": "xxhash"}}},
        "categorical_features": [
            {"name": "product_id", "kind": "categorical", "tower_name": "product"},
            {"name": "customer_id", "kind": "categorical", "tower_name": "user"},
            {"name": "search_query", "kind": "categorical", "tower_name": "query"}],
        "numerical_features": [
            {"name": "price", "kind": "numerical", "tower_name": "product"},
            {"name": "position", "kind": "numerical", "tower_name": "query"}],
        "bool_features": [{"name": "is_returning_user", "kind": "bool", "tower_name": "user"}],
        "timestamp_features": [{"name": "event_ts", "kind": "timestamp", "tower_name": "query"}],
    },
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(cfg, seed, n=256):
    log = make_ranking_log(num_rows=n, seed=seed)
    table = cfg.features.default_data_mapper({k: v for k, v in log.items() if k not in ("click", "conversion")})
    batch = {k: np.asarray(v) for k, v in table.items() if np.asarray(v).dtype != object}
    batch.update(click=log["click"], conversion=log["conversion"])
    return batch


def test_ranker_card_matches_cpu(cuda):
    """ranker.yaml's widths: the forward at 2e-5 and one step's loss (1e-5)
    and gradients (2e-4 norm-relative) on the card against the CPU."""
    cfg = RankerModelConfig.from_dict(RANKER)
    card, cpu = RankerModelWrapper(cfg, device=cuda, seed=1), RankerModelWrapper(cfg, device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in card.module.state_dict().items()})
    batch = _batch(cfg, 3)
    out_card, out_cpu = card.forward(batch), cpu.forward(batch)
    for k in out_cpu:
        np.testing.assert_allclose(out_card[k].cpu().numpy(), out_cpu[k].numpy(), rtol=2e-5, atol=2e-5, err_msg=k)
    losses = []
    for w in (card, cpu):
        loss, _, _ = w.loss_and_metrics(batch, None, True)
        loss.backward()
        losses.append(loss.item())
    assert abs(losses[0] - losses[1]) <= 1e-5
    for (n, pc), (_, pp) in zip(card.module.named_parameters(), cpu.module.named_parameters()):
        err = (pc.grad.cpu() - pp.grad).norm() / pp.grad.norm().clamp_min(1e-30)
        assert err <= 2e-4, n


def test_ranker_step_same_bits_twice(cuda):
    """One train_step from two wrappers of one seed: every parameter and
    AdamW moment the same bits (the QR tables' duplicate ids summed in a
    fixed order, nn.functional.sorted_segment_sum)."""
    cfg = RankerModelConfig.from_dict(RANKER)
    batch = _batch(cfg, 4)
    states = []
    for _ in range(2):
        st = TrainState.create(RankerModelWrapper(cfg, device=cuda, seed=2))
        train_step(st, batch)
        states.append(st.state_dict())
    for n, t in states[0]["module"].items():
        assert torch.equal(t, states[1]["module"][n]), n
    for pid, st in states[0]["optimizers"][0]["state"].items():
        for k, t in st.items():
            assert torch.equal(t, states[1]["optimizers"][0]["state"][pid][k]), (pid, k)


@pytest.mark.parametrize("top_k", [None, 2])
def test_moe_linear_card_matches_cpu(cuda, top_k):
    x = torch.randn(4, 33, 64, generator=torch.Generator().manual_seed(5))
    card = ttr.MoELinear(64, 96, 32, 4, torch.Generator(device=cuda).manual_seed(6), top_k=top_k, gate_sizes=(16,))
    cpu = ttr.MoELinear(64, 96, 32, 4, torch.Generator().manual_seed(0), top_k=top_k, gate_sizes=(16,))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    with torch.no_grad():
        np.testing.assert_allclose(card(x.to(cuda)).cpu().numpy(), cpu(x).numpy(), rtol=2e-5, atol=2e-5)


def test_sparse_moe_block_backward_same_bits_twice(cuda):
    """A bf16 sparse MoE block on the flash kernels at T = 512 of 1025: its
    gradients the same bits twice."""
    spec = ttr.MoESpec(num_experts=4, proj_features=64, ff_mult_factor=4, gate_sizes=(32,), top_k=2)
    block = ttr.TransformerBlock(128, 8, torch.Generator(device=cuda).manual_seed(7), attn_type="multi_query",
                                 is_causal=True, rotator=spec, is_sparse_attn=True, max_block_size=1025,
                                 sparsity_factor=0.5, n_cls=1, use_flash=True, dtype=torch.bfloat16)
    x = torch.randn(4, 1025, 128, device=cuda, generator=torch.Generator(device=cuda).manual_seed(8))
    grads = []
    for _ in range(2):
        block.zero_grad(set_to_none=True)
        block(x).float().square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in block.named_parameters()})
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
