"""The trainer's new knobs on the card: dropout masks are the same bits twice
for one seed and keep 1 - rate of their elements; remat on and off give the
same gradients with dropout on; ``steps_per_dispatch`` 2 ends on the bits
of 1, and a run resumed through the iterator snapshot on the uninterrupted
run's bits (lthm_tiny through main_training, with dropout, accumulation,
the process reader, grouping and a shuffle buffer).

These tests need an NVIDIA GPU and skip without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_trainer_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""

import os
import shutil

import numpy as np
import pytest
import torch

from recommendations_tpu_torch.nn import dropout as tdrop
from recommendations_tpu_torch.nn import transformer as ttr

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_masks_same_bits_twice_and_keep_rate(cuda, rate):
    def draw(seed):
        g = tdrop.seeded_generator(seed, cuda)
        return tdrop.token_dropout_mask(g, rate, 64, 513, cuda), tdrop.dropout(torch.ones(64, 513, 512, device=cuda),
                                                                               rate, g)

    a, b, c = draw(7), draw(7), draw(8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    n = a[1].numel()
    kept = (a[1] != 0).float().mean().item()
    assert abs(kept - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / n)


@pytest.mark.parametrize("bias", [False, True])
def test_remat_on_and_off_give_the_same_gradients_with_dropout(cuda, bias):
    """Two bf16 MQA 32x16 layers at T = 513 (with the bias: the window, the
    fused bias kernels) under dropout: remat recomputes each block with the
    masks of the first pass."""
    t = 513

    def grads(remat):
        stack = ttr.TransformerStack(2, 512, 32, torch.Generator(device=cuda).manual_seed(1), remat=remat,
                                     attn_type="multi_query", is_causal=True, use_bias=False,
                                     pos_bias_window=t if bias else None, use_flash=True, dtype=torch.bfloat16,
                                     dropout=0.1, attn_dropout=0.1)
        x = torch.randn(8, t, 512, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
        x.requires_grad_()
        stack(x, training=True, dropout_seed=3).float().square().sum().backward()
        return [x.grad] + [p.grad for p in stack.parameters()]

    for a, b in zip(grads(False), grads(True)):
        assert torch.equal(a, b)


KNOBS = ("model.transformer_config.attn_config.dropout=0.1", "model.transformer_config.attn_config.attn_dropout=0.1",
         "train.gradient_accumulation_steps=3", "data_loader.bypass_dataloader=false",
         "data_loader.process_reader=true", "data_loader.shuffle_buffer_num_mini_batches=2",
         "model.features.group_dataset={group_by_columns: [product_id], sort_by_columns: [customer_id], "
         "minimum_group_size: 1}")


def _run(tmp, tag, steps, extra=()):
    from recommendations_tpu_torch import main_training

    argv = ["--config-name", "lthm_tiny", "dataset.filesystem_config.kind=fake",
            f"export.filesystem_config.local_dir_prefix={tmp}", f"train.train_steps={steps}",
            "train.train_metrics_every_n_steps=1", "train.val_metrics_every_n_steps=4",
            f"trackers.trackers=[{{kind: jsonl, path: {tmp}/{tag}.jsonl}}]", f"model_version={tag}", *KNOBS, *extra]
    pipeline, metrics = main_training.main(argv, return_pipeline=True)
    return pipeline._trained[1], metrics


def _assert_same_bits(sa, sb):
    da, db = sa.state_dict(), sb.state_dict()
    for name, t in da["module"].items():
        assert torch.equal(t, db["module"][name]), name
    for oa, ob in zip(da["optimizers"], db["optimizers"]):
        for pid, st in oa["state"].items():
            for k, t in st.items():
                assert torch.equal(torch.as_tensor(t), torch.as_tensor(ob["state"][pid][k])), k
    assert torch.equal(sa.aux.logq.b, sb.aux.logq.b) and sa.step == sb.step


def test_steps_per_dispatch_and_snapshot_resume_give_the_same_bits(cuda, tmp_path):
    from recommendations_tpu_torch.data.data_store import FakeDataStore
    from recommendations_tpu_torch.tools.synth_data import write_synthetic_dataset

    FakeDataStore.reset()
    write_synthetic_dataset(None, ["20240101", "20240102"], 2, 48, 64, fake_store=True)
    tmp = str(tmp_path)
    s1, _ = _run(tmp, "k1", 8, ("train.checkpoint_every_k_steps=4", f"checkpoint_dir={tmp}/ckpt"))
    s2, _ = _run(tmp, "k2", 8, ("train.steps_per_dispatch=2",))
    _assert_same_bits(s1, s2)
    os.makedirs(f"{tmp}/resume")
    for name in ("step_00000004.pt", "data_iter_h0_s4.pkl"):
        shutil.copy(f"{tmp}/ckpt/{name}", f"{tmp}/resume/")
    s3, _ = _run(tmp, "resumed", 8, ("train.checkpoint_every_k_steps=4", f"checkpoint_dir={tmp}/resume"))
    _assert_same_bits(s1, s3)
