"""The trainable table's updates and the production attention layer at
lthm.yaml's own context 512 on the card; each table update gives the same
bits when run twice.

These tests need an NVIDIA GPU and skip without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_table_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""

import copy

import numpy as np
import pytest
import torch

from chip_smoke import bench_config, request_batch
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.nn.attention import MultiQueryAttention
from recommendations_tpu_torch.nn.embeddings import kshift_row_indices
from recommendations_tpu_torch.nn.functional import sorted_segment_sum
from recommendations_tpu_torch.ops import fused_attention as fa
from recommendations_tpu_torch.train import sparse_table as st
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState

pytestmark = pytest.mark.cuda

ATOL, RTOL = 1e-6, 1e-5  # float32 sums of a row's duplicates in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch_rows(rows, events):
    """A production-shaped batch's (token, shift) row ids (64 users, the
    last 4 events padding) and random gradients for them, on the card."""
    ids = torch.as_tensor(request_batch(7, 64, events)["product_ids"], device="cuda")
    idx = kshift_row_indices(ids, rows, 8).reshape(-1)
    g = torch.randn((idx.shape[0], 32), generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    g[(ids == 0).repeat_interleave(8).reshape(-1)] = 0.0  # padding tokens carry no gradient
    return idx, g


@pytest.mark.parametrize("rows,events", [(1_000_000, 264), (10_000_000, 1032)])
def test_sparse_fused_update_on_the_card_matches_the_cpu(cuda, rows, events):
    record = st.fused_record_init(rows, 32, torch.Generator(device="cuda").manual_seed(0))
    idx, g = _batch_rows(rows, events)
    cpu_rec, cpu_state = record.cpu(), st.FusedTableState(count=torch.zeros((), dtype=torch.int32))
    state = st.FusedTableState(count=torch.zeros((), dtype=torch.int32, device="cuda"))
    for _ in range(2):
        state, nan = st.sparse_fused_adam_update(record, idx, g, state, learning_rate=6e-4, b1=0.9, b2=0.95)
        cpu_state, cpu_nan = st.sparse_fused_adam_update(cpu_rec, idx.cpu(), g.cpu(), cpu_state,
                                                         learning_rate=6e-4, b1=0.9, b2=0.95)
    assert int(state.count) == int(cpu_state.count) == 2 and not bool(nan) and not bool(cpu_nan)
    got = record.cpu()
    moved = (got != cpu_rec).any(dim=1)
    touched = torch.unique(idx[(g != 0).any(dim=1)]).cpu()
    assert not moved[~torch.isin(torch.arange(rows), touched)].any()  # the rest bit for bit
    np.testing.assert_allclose(got[touched].numpy(), cpu_rec[touched].numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rows,events", [(1_000_000, 264), (10_000_000, 1032)])
def test_lazy_update_on_the_card_matches_the_cpu(cuda, rows, events):
    gen = torch.Generator(device="cuda").manual_seed(2)
    table = torch.randn((rows, 32), generator=gen, device="cuda")
    idx, g = _batch_rows(rows, events)
    grad = torch.zeros_like(table).index_add_(0, idx, g)
    cap = idx.numel()
    cpu_table = table.cpu()
    state, cpu_state = st.init_lazy_row_state(table), st.init_lazy_row_state(cpu_table)
    for _ in range(2):
        state = st.lazy_rowwise_adam_update(table, grad, state, learning_rate=6e-4, capacity=cap, b1=0.9, b2=0.95)
        cpu_state = st.lazy_rowwise_adam_update(cpu_table, grad.cpu(), cpu_state, learning_rate=6e-4,
                                                capacity=cap, b1=0.9, b2=0.95)
    assert int(state.count) == int(cpu_state.count) == 2
    for got, want in ((table, cpu_table), (state.m, cpu_state.m), (state.v, cpu_state.v)):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_production_layer_at_513_takes_the_bias_kernels_and_agrees_with_sdpa(cuda):
    """One production attention layer (d=512, MQA 32x16, bf16, window 513)
    at T = 513: on the card the fused bias kernels run (the CUDA dispatch)
    and agree with the same layer on _sdpa with the bias, held as the bf16
    layer tests hold it: a few bf16 ulps (4 * 2**-8) of the output's and the
    input gradient's largest element, the table at bf16 values (the kernels
    apply the table at bf16)."""
    b, t = 4, 513
    gen = torch.Generator(device="cuda").manual_seed(3)
    fused = MultiQueryAttention(512, 32, gen, use_bias=False, pos_bias_window=t, use_flash=True,
                                dtype=torch.bfloat16)
    with torch.no_grad():
        fused.pos_bias.bias.copy_(torch.randn(fused.pos_bias.bias.shape, generator=gen, device="cuda")
                                  .bfloat16().float())
    plain = MultiQueryAttention(512, 32, gen, use_bias=False, pos_bias_window=t, use_flash=False,
                                dtype=torch.bfloat16)
    plain.load_state_dict(fused.state_dict())
    x = torch.randn((b, t, 512), generator=gen, device="cuda").bfloat16()
    dy = torch.randn((b, t, 512), generator=gen, device="cuda").bfloat16()
    results = []
    for layer in (fused, plain):
        xi = x.clone().requires_grad_()
        before = fa.FLASH_BIAS_FWD.launches
        y = layer(xi, causal=True)
        y.backward(dy)
        results.append((y.float(), xi.grad.float(), fa.FLASH_BIAS_FWD.launches - before))
    (y_f, dx_f, n_f), (y_p, dx_p, n_p) = results
    assert (n_f, n_p) == (1, 0)
    for got, want in ((y_f, y_p), (dx_f, dx_p)):
        tol = 4 * 2**-8 * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol


def _one_step_on_a_trainable_table(table_optimizer, ids):
    """A fresh LTHM-base model (2 layers, bf16, a 1M-row table that trains)
    on the card and one training step on ``ids`` at fixed offsets: (whether
    the table moved, the table after the step (the fused record's moments
    included), every tensor of the table state and of the optimizers'
    states), on the host."""
    d = copy.deepcopy(bench_config())
    d["transformer_config"]["num_layers"] = 2
    d["product_tower"]["detach_item_tower"] = False
    d["table_optimizer"] = table_optimizer
    wrapper = LTHMModelWrapper(LTHMModelConfig.from_dict(d), device="cuda", seed=4)
    table = wrapper.module.product_emb_module.embedding
    before = table.detach().cpu()
    state = TrainState.create(wrapper)
    batch = request_batch(5, 16, ids.shape[1])
    batch["product_ids"] = ids
    train_step(state, batch, offsets=[0, 5, 6, 12, 24, 30])
    after = table.detach().cpu()
    states = [t.cpu() for t in (state.table_state or ()) if torch.is_tensor(t)]
    for opt in state.optimizer.optimizers():
        for per_param in opt.state.values():
            states += [t.cpu() for t in per_param.values() if torch.is_tensor(t)]
    return bool((after != before).any()), after, states


@pytest.mark.parametrize("table_optimizer", ["rowwise_adam", "lazy_rowwise_adam", "adamw", "sparse_fused_adam"])
def test_table_updates_give_the_same_bits_twice(cuda, table_optimizer):
    """Fault 3c: a row's duplicate gradients are summed in a fixed order on
    the card, so one training step from one state gives the same table bits
    twice. The batch repeats ids on purpose: one popular id in a third of
    the events, a second in every user's first event, and the padding id in
    the last four, so many rows are hit hundreds of times."""
    ids = request_batch(6, 16, 264)["product_ids"]
    ids[:, ::3] = 1234567
    ids[:, 0] = -98765
    moved, first, first_states = _one_step_on_a_trainable_table(table_optimizer, ids)
    _, second, second_states = _one_step_on_a_trainable_table(table_optimizer, ids)
    assert moved, "the table did not train"
    assert torch.equal(first, second)
    assert len(first_states) == len(second_states) > 0
    for a, b in zip(first_states, second_states):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sorted_segment_sum_on_the_card_equals_the_cpu(cuda, dtype):
    """The duplicate-row sum behind both table gradients: on the card the
    same bits as on the CPU (each row's duplicates added one after the other
    in their order of occurrence, every add rounded to the dtype), with one
    row hit by a third of the 20000 rows."""
    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 50, (20000,), generator=gen)
    idx[::3] = 7
    rows = torch.randn(20000, 32, generator=gen).to(dtype)
    want_rows, want = sorted_segment_sum(idx, rows)
    got_rows, got = sorted_segment_sum(idx.to(cuda), rows.to(cuda))
    assert torch.equal(got_rows.cpu(), want_rows) and torch.equal(got.cpu(), want)
