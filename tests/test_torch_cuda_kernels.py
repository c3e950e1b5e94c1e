"""The port's CUDA kernels on the card, each against its plain version.

These tests need an NVIDIA GPU and skip without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which this file and the
machine with the card do without.)
"""

import pytest
import torch

from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.ops import fused_attention as fa

pytestmark = pytest.mark.cuda

LSE_TOL = 1e-4  # f32 logsumexp; sums in another order


def o_tolerance(dtype, o_ref):
    """f32: as the JAX kernel tests. bf16: the output is rounded to bf16 and
    p is rounded before the PV product, so a sum taken in another order may
    land on the neighbouring bf16 value: 2**-8 of the largest output."""
    if dtype == torch.float32:
        return 2e-5
    return 2**-8 * max(1.0, o_ref.float().abs().max().item())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, t, n_head, hd, kvh, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, t, n_head * hd, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, t, kvh * hd, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, t, kvh * hd, generator=g, device="cuda").to(dtype)
    return q, k, v


@pytest.mark.parametrize(
    "b,t,n_head,hd,kvh,dtype,causal",
    [
        (64, 257, 32, 16, 1, torch.bfloat16, True),  # the serving shape
        (2, 70, 32, 16, 1, torch.bfloat16, True),
        (4, 257, 32, 16, 32, torch.bfloat16, False),
        (4, 257, 32, 16, 1, torch.float32, True),
        (4, 70, 4, 16, 4, torch.float32, False),
        (2, 1100, 32, 16, 1, torch.bfloat16, True),
        (2, 1100, 4, 16, 4, torch.float32, False),
        (2, 96, 4, 8, 1, torch.float32, True),
        (2, 96, 4, 32, 4, torch.bfloat16, True),
        (2, 96, 2, 64, 2, torch.float32, True),
        (2, 600, 16, 32, 1, torch.bfloat16, True),
        (2, 300, 16, 64, 1, torch.bfloat16, False),
        (2, 96, 4, 16, 1, torch.bfloat16, True),
    ],
)
def test_flash_fwd_kernel_matches_plain_version(cuda, b, t, n_head, hd, kvh, dtype, causal):
    q, k, v = _qkv(b, t, n_head, hd, kvh, dtype)
    before = fa.FLASH_FWD.launches
    o, lse = fa.fused_flash_attention_fwd(q, k, v, n_head, causal)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD.launches == before + 1
    ro, rl = fa.fused_flash_attention_reference(q, k, v, n_head, causal)
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == (b, t, n_head)
    assert (o.float() - ro.float()).abs().max().item() <= o_tolerance(dtype, ro)
    assert (lse - rl).abs().max().item() <= LSE_TOL


def test_flash_fwd_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(1, 16, 2, 16, 1, torch.bfloat16)
    before = fa.FLASH_FWD.launches
    strided = torch.cat([q, q], dim=-1)[..., : q.shape[-1]]  # same shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_flash_attention(strided, k, v, 2)
    with pytest.raises(ValueError, match="head dim"):
        fa.fused_flash_attention(*_qkv(1, 16, 2, 12, 1, torch.float32), 2)
    with pytest.raises(TypeError):
        fa.fused_flash_attention(q.half(), k.half(), v.half(), 2)
    with pytest.raises(ValueError, match="one device"):
        fa.fused_flash_attention(q, k.cpu(), v.cpu(), 2)
    assert fa.FLASH_FWD.launches == before


def test_serving_forward_on_card_matches_cpu(cuda):
    """f32 compute: the card (kernel, cuBLAS) against the CPU (plain
    version) with the same weights."""
    d = dict(
        compute_dtype="float32",
        transformer_config=dict(
            rotator_config={"ff_mult": 4}, is_causal=True, num_layers=2, use_flash_attention=True,
            attn_config=dict(n_head=4, n_embd=64, attn_type="multi_query", bias=False),
        ),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=64, product_emb_dim=32, norm_bins=8,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 16}],
            latent_model_config={"vocab_size_latent": 5000, "num_shifts_latent": 4,
                                 "normalize_embedding": True},
        ),
        lookahead=[0, 2, 4], context_width=48, table_optimizer="frozen",
    )
    gpu = LTHMModelWrapper(LTHMModelConfig.from_dict(d))
    cpu = LTHMModelWrapper(LTHMModelConfig.from_dict(d), device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in gpu.module.state_dict().items()})
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(-(2**62), 2**62, (4, 56), generator=g)
    ids[:, -5:] = 0
    batch = {
        "product_ids": ids,
        "labels": torch.randint(0, 4, (4, 56), generator=g).float(),
        "timestamps": torch.randint(1_600_000_000, 1_700_000_000, (4, 56), generator=g).float(),
    }
    before = fa.FLASH_FWD.launches
    got = gpu.inference_models()["user_encoder"](batch)["user_emb"]
    torch.cuda.synchronize()
    assert fa.FLASH_FWD.launches == before + 2  # one per layer
    want = cpu.inference_models()["user_encoder"](batch)["user_emb"]
    assert got.is_cuda and got.shape == (4, 32)
    assert (got.cpu() - want).abs().max().item() <= 1e-4
