"""The trainable table's updates and the production attention layer at
lthm.yaml's own context 512 on the card.

These tests need an NVIDIA GPU and skip without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_table_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""

import numpy as np
import pytest
import torch

from chip_smoke import request_batch
from recommendations_tpu_torch.nn.attention import MultiQueryAttention
from recommendations_tpu_torch.nn.embeddings import kshift_row_indices
from recommendations_tpu_torch.ops import fused_attention as fa
from recommendations_tpu_torch.train import sparse_table as st

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
