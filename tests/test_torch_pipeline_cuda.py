"""The pipeline extras on the card: a traced ``.pt2`` program launches the
bias forward kernel through its operator (the launch counter moves by one a
layer a call) and gives the eager wrapper's bits; the KNN eval's chunked
top-k merge equals one full product and ``torch.topk`` on the card; the
pretrained product-embedding module on the card within 2e-5 of the CPU's
(f32).

These tests need an NVIDIA GPU and skip without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_pipeline_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""

import copy

import numpy as np
import pytest
import torch

from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.pretrained import PretrainedProductEmbedding
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.ops import fused_attention as fa
from recommendations_tpu_torch.pipeline import export as texport
from recommendations_tpu_torch.pipeline import knn_eval as tknn

pytestmark = pytest.mark.cuda

LAYERS, CONTEXT = 2, 63  # T = 64 = the bias window: the bias kernels on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def bias_config() -> dict:
    """lthm.yaml's attention (MQA 32x16, bf16, the position bias) at 2 layers
    and context 63."""
    return dict(
        features={"defaults": {}}, compute_dtype="bfloat16", context_width=CONTEXT, lookahead=[0, 2],
        transformer_config=dict(
            rotator_config={"ff_mult": 2}, is_causal=True, num_layers=LAYERS, use_flash_attention=True,
            attn_config=dict(n_head=32, n_embd=512, attn_type="multi_query", dropout=0.0, attn_dropout=0.0,
                             bias=False, pos_bias={"context_window": CONTEXT + 1}),
        ),
        product_tower=dict(inp_emb_dim=32, out_emb_dim=512, product_emb_dim=128, norm_bins=8,
                           cosine_lsh_config=[{"num_bins": 8, "num_proj": 16}],
                           latent_model_config={"vocab_size_latent": 100000, "num_shifts_latent": 8,
                                                "normalize_embedding": False}),
        log_q_config={"num_buckets": 1024, "hash_offsets": [0]},
    )


def batch_of(b=8, s=CONTEXT, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(-(2**62), 2**62, size=(b, s)).astype(np.int64)
    ids[:, -5:] = 0
    return {"product_ids": ids, "labels": rs.randint(0, 4, size=(b, s)).astype(np.float32),
            "timestamps": rs.randint(1_600_000_000, 1_700_000_000, size=(b, s)).astype(np.float32)}


def test_pt2_program_launches_the_bias_kernel(cuda, tmp_path):
    wrapper = LTHMModelWrapper(LTHMModelConfig.from_dict(bias_config()), device="cuda")
    batch = batch_of()
    texport.export_model_artifacts(wrapper, str(tmp_path), trace_batch=batch)
    for name in ("user_encoder", "sequence_encoder"):
        program = texport.load_inference_program(str(tmp_path), name, device="cuda")
        eager = wrapper.inference_models()[name](batch)
        before = fa.FLASH_BIAS_FWD.launches
        got = program(batch)
        torch.cuda.synchronize()
        assert fa.FLASH_BIAS_FWD.launches - before == LAYERS, name
        for k in eager:
            assert torch.equal(got[k], eager[k]), (name, k)


def test_knn_merge_equals_one_shot_topk(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, d, b, k = 5000, 128, 32, 200
    emb = torch.nn.functional.normalize(torch.randn(n, d, generator=gen, device="cuda"), dim=-1).cpu().numpy()
    ids = np.arange(1, n + 1, dtype=np.int64)
    qe = torch.nn.functional.normalize(torch.randn(b, d, generator=gen, device="cuda"), dim=-1)
    v_c, i_c = tknn.chunked_topk(qe, tknn._catalog_chunks(emb, ids, 1024, cuda), k)
    v_1, idx_1 = (qe @ torch.from_numpy(emb).to(cuda).T).topk(k, dim=1)
    assert torch.equal(v_c, v_1)
    v = v_1.cpu().numpy()
    untied = (np.diff(v, axis=1, prepend=np.inf) != 0) & (np.diff(v, axis=1, append=-np.inf) != 0)
    np.testing.assert_array_equal(i_c.cpu().numpy()[untied], ids[idx_1.cpu().numpy()][untied])


def test_pretrained_module_card_vs_cpu(cuda):
    cpu = PretrainedProductEmbedding(4096, 32, torch.Generator(device="cpu").manual_seed(0), num_shifts=8)
    card = copy.deepcopy(cpu).to(cuda)
    ids = torch.from_numpy(np.random.RandomState(1).randint(-(2**62), 2**62, size=(16, 40)).astype(np.int64))
    want = cpu(ids)
    got = card(ids.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
