"""The port's CUDA kernels on the card, each against its plain version.

These tests need an NVIDIA GPU and skip without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX, which this file and the
machine with the card do without.)
"""

import math
from unittest import mock

import pytest
import torch

from chip_smoke import bias_reference, ce_inputs, compare_ce
from recommendations_tpu_torch.models.lthm import loss as tloss
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.nn import logq as tlogq
from recommendations_tpu_torch.ops import fused_attention as fa
from recommendations_tpu_torch.ops import fused_ce as fc
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState

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
        (16, 1025, 32, 16, 1, torch.bfloat16, True),  # the long-history shape: a block walks 17 tiles
        (32, 450, 32, 16, 1, torch.bfloat16, True),
        (2, 1025, 32, 16, 1, torch.bfloat16, True),   # ragged last tiles
        (2, 1026, 32, 16, 1, torch.bfloat16, False),
        (2, 1, 32, 16, 1, torch.bfloat16, True),      # one row
    ],
)
def test_flash_fwd_kernel_matches_plain_version(cuda, b, t, n_head, hd, kvh, dtype, causal):
    """Against the plain version at the kernel's own softmax arithmetic
    (``kernel_softmax``), taken over 4 batch rows at a time."""
    q, k, v = _qkv(b, t, n_head, hd, kvh, dtype)
    before = fa.FLASH_FWD.launches
    o, lse = fa.fused_flash_attention_fwd(q, k, v, n_head, causal)
    torch.cuda.synchronize()
    assert fa.FLASH_FWD.launches == before + 1
    arith = fa.kernel_softmax(q, k, n_head)
    parts = [fa.fused_flash_attention_reference(q[i : i + 4], k[i : i + 4], v[i : i + 4], n_head, causal, **arith)
             for i in range(0, b, 4)]
    ro, rl = torch.cat([x[0] for x in parts]), torch.cat([x[1] for x in parts])
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


def bwd_tolerance(dtype, ref):
    """f32: the JAX kernel tests' gradient tolerance, 2e-4 absolute and
    relative. bf16: ds and p are rounded before the products and the outputs
    once at the end, so a sum taken in another order may land on the
    neighbouring bf16 value: 2**-8 of the largest output."""
    if dtype == torch.float32:
        return 2e-4 + 2e-4 * ref.float().abs()
    return 2**-8 * max(1.0, ref.float().abs().max().item())


BWD_SHAPES = [
    (64, 257, 32, 16, 1, torch.bfloat16, True),  # the LTHM-base training shape
    (2, 70, 32, 16, 1, torch.bfloat16, True),
    (2, 450, 32, 16, 1, torch.bfloat16, True),   # the JAX two-kernel regime
    (2, 1100, 32, 16, 1, torch.bfloat16, True),  # the JAX grid regime
    (4, 257, 32, 16, 32, torch.bfloat16, True),  # MHA
    (4, 257, 32, 16, 1, torch.float32, True),
    (4, 257, 32, 16, 1, torch.bfloat16, False),
    (2, 300, 16, 32, 1, torch.bfloat16, True),
    (2, 300, 16, 64, 1, torch.bfloat16, False),
    (2, 1100, 4, 16, 4, torch.float32, False),
    (2, 96, 4, 8, 1, torch.float32, True),
    (2, 96, 2, 64, 2, torch.float32, True),
    (2, 96, 4, 16, 1, torch.bfloat16, True),     # MQA with 4 heads: FMA path
    (16, 1025, 32, 16, 1, torch.bfloat16, True),  # the long-history shape: several items a dK/dV block
    (32, 450, 32, 16, 1, torch.bfloat16, True),
    (2, 1025, 32, 16, 1, torch.bfloat16, True),   # ragged last key block
    (2, 1026, 32, 16, 1, torch.bfloat16, False),
    (2, 1, 32, 16, 1, torch.bfloat16, True),      # one row
]


@pytest.mark.parametrize("b,t,n_head,hd,kvh,dtype,causal", BWD_SHAPES)
def test_flash_bwd_kernel_matches_plain_version(cuda, b, t, n_head, hd, kvh, dtype, causal):
    q, k, v = _qkv(b, t, n_head, hd, kvh, dtype)
    o, lse = fa.fused_flash_attention_fwd(q, k, v, n_head, causal)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(9), device="cuda")
    before = fa.FLASH_BWD.launches
    got = fa.fused_flash_attention_bwd(q, k, v, o, lse, do, n_head, causal)
    torch.cuda.synchronize()
    assert fa.FLASH_BWD.launches == before + 1
    exp2 = fa.kernel_softmax(q, k, n_head)["exp2"]
    parts = [fa.fused_flash_attention_bwd_reference(q[i : i + 4], k[i : i + 4], v[i : i + 4], o[i : i + 4],
                                                    lse[i : i + 4], do[i : i + 4], n_head, causal, exp2=exp2)
             for i in range(0, b, 4)]
    want = [torch.cat([x[j] for x in parts]) for j in range(3)]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        err = (g.float() - w.float()).abs()
        assert bool((err <= bwd_tolerance(dtype, w)).all()), f"{name}: max err {err.max().item()}"


def test_flash_bwd_is_deterministic(cuda):
    q, k, v = _qkv(8, 257, 32, 16, 1, torch.bfloat16)
    o, lse = fa.fused_flash_attention_fwd(q, k, v, 32, True)
    do = torch.randn_like(q)
    a = fa.fused_flash_attention_bwd(q, k, v, o, lse, do, 32, True)
    b = fa.fused_flash_attention_bwd(q, k, v, o, lse, do, 32, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_bwd_is_deterministic_at_the_long_history_shape(cuda):
    """B=16, T=1025: a dK/dV block walks several (key block, batch row)
    items and a forward block 17 K/V tiles; two runs give the same bits."""
    q, k, v = _qkv(16, 1025, 32, 16, 1, torch.bfloat16, seed=4)
    tiles, items = fa.block_walk(q, k, 32)
    assert tiles == 17 and items > 1
    o, lse = fa.fused_flash_attention_fwd(q, k, v, 32, True)
    assert all(torch.equal(x, y) for x, y in zip((o, lse), fa.fused_flash_attention_fwd(q, k, v, 32, True)))
    do = torch.randn_like(q)
    a = fa.fused_flash_attention_bwd(q, k, v, o, lse, do, 32, True)
    b = fa.fused_flash_attention_bwd(q, k, v, o, lse, do, 32, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_bwd_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(1, 16, 2, 16, 1, torch.bfloat16)
    o, lse = fa.fused_flash_attention_fwd(q, k, v, 2)
    before = fa.FLASH_BWD.launches
    strided = torch.cat([q, q], dim=-1)[..., : q.shape[-1]]
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_flash_attention_bwd(strided, k, v, o, lse, q, 2)
    q12, k12, v12 = _qkv(1, 16, 2, 12, 1, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fa.fused_flash_attention_bwd(q12, k12, v12, q12, lse, q12, 2)
    with pytest.raises(ValueError, match="lse"):
        fa.fused_flash_attention_bwd(q, k, v, o, lse[:, :8], q, 2)
    assert fa.FLASH_BWD.launches == before


def test_flash_attention_autograd_launches_both_kernels(cuda):
    q, k, v = (x.requires_grad_() for x in _qkv(2, 70, 32, 16, 1, torch.bfloat16))
    fwd, bwd = fa.FLASH_FWD.launches, fa.FLASH_BWD.launches
    o = fa.fused_flash_attention(q, k, v, 32, True)
    assert "flash_attention_default" in o.grad_fn.name()
    o.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches) == (fwd + 1, bwd + 1)
    assert all(x.grad is not None and bool(torch.isfinite(x.grad.float()).all()) for x in (q, k, v))


def _small_config():
    return dict(
        compute_dtype="float32",
        transformer_config=dict(
            rotator_config={"ff_mult": 4}, is_causal=True, num_layers=2, use_flash_attention=True,
            attn_config=dict(n_head=4, n_embd=64, attn_type="multi_query", bias=False,
                             dropout=0.0, attn_dropout=0.0),
        ),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=64, product_emb_dim=32, norm_bins=8,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 16}],
            latent_model_config={"vocab_size_latent": 5000, "num_shifts_latent": 4,
                                 "normalize_embedding": True},
        ),
        lookahead=[0, 2, 4], context_width=48, table_optimizer="frozen",
        log_q_config={"num_buckets": 4096, "hash_offsets": [0, 7]}, train_mini_batch_size=3,
    )


def _small_batch(seed=5):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(-(2**62), 2**62, (4, 56), generator=g)
    ids[:, -5:] = 0
    return {
        "product_ids": ids,
        "labels": torch.randint(0, 4, (4, 56), generator=g).float(),
        "timestamps": torch.randint(1_600_000_000, 1_700_000_000, (4, 56), generator=g).float(),
    }


def _pair_on_card_and_cpu():
    d = _small_config()
    gpu = LTHMModelWrapper(LTHMModelConfig.from_dict(d))
    cpu = LTHMModelWrapper(LTHMModelConfig.from_dict(d), device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in gpu.module.state_dict().items()})
    return gpu, cpu


def test_serving_forward_on_card_matches_cpu(cuda):
    """f32 compute: the card (kernel, cuBLAS) against the CPU (plain
    version) with the same weights."""
    gpu, cpu = _pair_on_card_and_cpu()
    batch = _small_batch()
    before = fa.FLASH_FWD.launches
    got = gpu.inference_models()["user_encoder"](batch)["user_emb"]
    torch.cuda.synchronize()
    assert fa.FLASH_FWD.launches == before + 2  # one per layer
    want = cpu.inference_models()["user_encoder"](batch)["user_emb"]
    assert got.is_cuda and got.shape == (4, 32)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


def test_training_step_on_card_matches_cpu(cuda):
    """One f32 training step with the same weights, batch and offsets: the
    card (kernels, cuBLAS) against the CPU (plain versions). Held as the CPU
    parity tests hold the port to the JAX package: the loss at 1e-4, each
    gradient at 2e-4 norm-relative (the cosine-LSH tables, a bf16 product in
    a float32 model, at one bf16 ulp), and the updated parameters at 2e-4
    norm-relative. (AdamW's first step is about lr * sign(g) per element, so
    steps of elements whose gradient is near eps are not compared alone.)"""
    gpu, cpu = _pair_on_card_and_cpu()
    batch, offsets = _small_batch(7), [0, 1, 3]
    launches = (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches)
    results = []
    for w in (gpu, cpu):
        state = TrainState.create(w)
        state.optimizer.zero_grad()
        loss, _, _ = w.loss_and_metrics(batch, state.aux, True, offsets=offsets)
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in w.module.named_parameters() if p.grad is not None}
        state.optimizer.step()
        params = {n: p.detach().cpu() for n, p in w.module.named_parameters()}
        results.append((loss.item(), grads, params))
    torch.cuda.synchronize()
    assert (fa.FLASH_FWD.launches, fa.FLASH_BWD.launches) == (launches[0] + 2, launches[1] + 2)
    (lg, gg, pg), (lc, gc, pc) = results
    assert abs(lg - lc) <= 1e-4
    assert set(gg) == set(gc)

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    for name in gc:
        tol = 2**-8 if ".direction_emb_" in name else 2e-4
        assert rel(gg[name], gc[name]) <= tol, name
    for name in pc:
        assert rel(pg[name], pc[name]) <= 2e-4, name


# -- the fused contrastive CE ------------------------------------------------

CE_TOL = 2e-5  # ce, lse, diag: f32, absolute plus relative


def _ce_inputs(n, s, d, invalid_user=False, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def unit():
        return torch.nn.functional.normalize(torch.randn(n, d, generator=g, device="cuda"), dim=-1).bfloat16()

    q, c = unit(), unit()
    v = torch.rand(n, generator=g, device="cuda") >= 0.1
    if invalid_user:
        v[s : 2 * s] = False
    lq = -torch.log(torch.rand(n, generator=g, device="cuda") * 1e4 + 1.0)
    dce = torch.rand(n, generator=g, device="cuda") * v
    return q, c, v, lq, dce


def _bf16_ulp(ref):
    top = ref.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


@pytest.mark.parametrize(
    "n,s,d,beta,invalid_user",
    [
        (8192, 256, 128, 0.0, False),  # one 32-user chunk of LTHM-base
        (100, 10, 16, 1.0, False),
        (2048, 64, 64, 1.0, True),
        (1024, 32, 32, 0.5, False),
        (256, 256, 128, 1.0, False),   # one user: every off-diagonal masked
        (8448, 264, 16, 1.0, True),    # 64-row blocks (the stream split), a ragged last stage
        (17000, 100, 32, 0.5, True),   # 128-row blocks, a ragged last block
        (32768, 1024, 64, 1.0, False),  # the production chunk's shape at D = 64
    ],
)
def test_fused_ce_kernels_match_plain_versions(cuda, n, s, d, beta, invalid_user):
    """ce and lse within 2e-5 (f32 sums in another order); rank equal but on
    rows where a live logit lies within 1e-4 of the positive's (the kernel's
    tensor-core sums and the plain f32 GEMM order 128 products differently);
    dq and dc within one bf16 ulp of the largest element, with a floor of
    2**-16 * inv_t where the gradient vanishes (rows whose only live column
    is their own)."""
    q, c, v, lq, dce = _ce_inputs(n, s, d, invalid_user, seed=n)
    before = [k.launches for k in fc.KERNELS]
    ce, rank, lse = fc.ce_forward(q, c, v, lq, s, 20.0, beta)
    dq, dc = fc.ce_backward(q, c, v, lq, lse, dce, s, 20.0, beta)
    torch.cuda.synchronize()
    assert [k.launches for k in fc.KERNELS] == [b + 1 for b in before]
    rce, rrank, rlse = fc.ce_forward_reference(q, c, v, lq, s, 20.0, beta)
    fin = torch.isfinite(rce)
    assert torch.equal(torch.isfinite(ce), fin)
    for got, want in ((ce, rce), (lse, rlse)):
        assert ((got - want).abs()[fin] <= CE_TOL * (1 + want.abs()[fin])).all()
    logits, _, eye = fc._masked_plane(q, c, v, lq, s, 20.0, beta)
    diag = fc.row_diag_reference(q, c, v, 20.0)
    near = (((logits - diag[:, None]).abs() <= 1e-4) & ~eye & (logits > -1e8)).any(-1)
    assert not bool(((rank != rrank) & ~near).any())
    for got, want in zip((dq, dc), fc.ce_backward_reference(q, c, v, lq, rlse, dce, s, 20.0, beta)):
        assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
        tol = max(_bf16_ulp(want), 2**-16 * 20.0)
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize(
    "n,s,d,beta,pattern",
    [
        (32768, 1024, 128, 0.0, "roll"),     # the production chunk: 128-row blocks (the own-row split)
        (8192, 256, 128, 0.0, "roll"),       # LTHM-base: 64-row blocks whose two warpgroups split the stream
        (20000, 100, 64, 1.0, "random"),     # the own-row split at D = 64, a ragged last block
        (100, 10, 16, 1.0, "random"),        # N not a multiple of any tile, D = 16
        (1024, 32, 32, 0.5, "random"),
        (512, 32, 16, 1.0, "one_user"),      # fully masked rows: ce = -inf
        (2048, 64, 64, 1.0, "invalid_user"),  # a user with every slot invalid
        (8448, 264, 128, 1.0, "random"),     # N = 8448, a 264-token context: a ragged last stage
        (17000, 100, 32, 0.5, "random"),     # the own-row split at D = 32 and 16
        (17000, 50, 16, 1.0, "invalid_user"),
        (8448, 264, 32, 0.5, "one_user"),     # one valid user in a split grid: fully masked rows
        (8448, 264, 64, 1.0, "invalid_user"),
        (17000, 1000, 128, 1.0, "invalid_user"),  # 128-row blocks, a user with every slot invalid
        (17000, 1000, 64, 0.0, "one_user"),
        (32768, 1024, 16, 1.0, "random"),     # the production chunk at D = 16 and 32
        (32768, 1024, 32, 0.5, "invalid_user"),
    ],
)
def test_fused_ce_kernels_at_chip_smoke_shapes(cuda, n, s, d, beta, pattern):
    """The four CE kernels (ce_fwd, ce_dq and ce_dc on wgmma kernels) against
    their plain versions at chip_smoke.py's tolerances and input patterns,
    and twice for the same bits (compare_ce raises on any failure)."""
    compare_ce(fc, n, s, d, beta, pattern)


def test_ce_dc_with_negative_weights(cuda):
    """dce of either sign (the kernel folds |dce| inv_t into the exponent and
    applies the sign apart): dc within one bf16 ulp of the largest element."""
    q, c, v, lq, _ = _ce_inputs(2048, 64, 128, seed=5)
    dce = torch.randn(2048, generator=torch.Generator(device="cuda").manual_seed(6), device="cuda") * v
    _, _, lse = fc.ce_forward(q, c, v, lq, 64, 20.0, 1.0)
    dq, dc = fc.ce_backward(q, c, v, lq, lse, dce, 64, 20.0, 1.0)
    torch.cuda.synchronize()
    want = fc.ce_grad_reference(q, c, v, lq, lse, dce, 64, 20.0, 1.0, "c")
    assert (dc.float() - want.float()).abs().max().item() <= max(_bf16_ulp(want), 2**-16 * 20.0)


@pytest.mark.parametrize(
    "n,s,d",
    [
        (2048, 64, 128),    # the stream split (N / 128 below the SM count)
        (20000, 100, 64),   # the own-row split, a ragged last block
        (32768, 1024, 128),  # the production chunk
    ],
)
def test_ce_dq_with_negative_weights_and_guard_rows(cuda, n, s, d):
    """ce_dq takes the weight's sign per own (query) row, where ce_dc takes
    it per stream row: dce of either sign, LSE_GUARD rows (lse at -1e9: p = 0,
    so a row's gradient is -dce inv_t c_i alone) and a user with every slot
    invalid. dq and dc within one bf16 ulp of the largest element, and the
    same bits twice."""
    q, c, v, lq, _ = _ce_inputs(n, s, d, invalid_user=True, seed=7)
    dce = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(8), device="cuda") * v
    _, _, lse = fc.ce_forward(q, c, v, lq, s, 20.0, 1.0)
    lse = lse.clone()
    lse[::97] = -1e9
    dce[::97] = 1.0
    got = fc.ce_backward(q, c, v, lq, lse, dce, s, 20.0, 1.0)
    again = fc.ce_backward(q, c, v, lq, lse, dce, s, 20.0, 1.0)
    torch.cuda.synchronize()
    for name, g_, a_, wrt in zip(("dq", "dc"), got, again, "qc"):
        want = fc.ce_grad_reference(q, c, v, lq, lse, dce, s, 20.0, 1.0, wrt)
        assert torch.equal(g_, a_), name
        err = (g_.float() - want.float()).abs().max().item()
        assert err <= max(_bf16_ulp(want), 2**-16 * 20.0), (name, err)


def _row_diag(q, c, v, lq, beta):
    """One launch of ce_row_diag: (diag, m)."""
    n, d = q.shape
    diag, m = torch.empty(n, device=q.device), torch.empty((), device=q.device)
    fc.CE_ROW_DIAG.launch(q.data_ptr(), c.data_ptr(), v.data_ptr(), lq.data_ptr(), diag.data_ptr(), m.data_ptr(),
                          n, d, 20.0, beta, torch.cuda.current_stream().cuda_stream)
    return diag, m


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n", [1, 7, 100, 8192, 8448, 17000, 32768])
def test_ce_row_diag_matches_plain_pair(cuda, n, d):
    """diag within 2e-5 absolute plus relative (f32 sums in another order),
    -1e9 on the invalid rows, the shift m bit for bit, and the same bits on
    a second launch: from one row (a grid of one row block and the shift
    block) to the production chunk, at every width (a row is D/8 threads)."""
    q, c, v, lq, _ = _ce_inputs(n, 16, d, seed=n + d)
    v[::5] = False
    for beta in (0.0, 1.0, 0.37):
        diag, m = _row_diag(q, c, v, lq, beta)
        diag2, m2 = _row_diag(q, c, v, lq, beta)
        torch.cuda.synchronize()
        want_diag, want_m = fc.row_diag_and_shift_reference(q, c, v, lq, 20.0, beta)
        assert ((diag - want_diag).abs() <= CE_TOL * (1 + want_diag.abs())).all()
        assert torch.equal(diag[~v], want_diag[~v])
        assert _same_bits(m, want_m), (m.item(), want_m.item())
        assert _same_bits(diag, diag2) and _same_bits(m, m2)


def test_ce_row_diag_shift_propagates_nan(cuda):
    """One NaN anywhere in lq (the head, the 16-byte body or the tail the
    shift block reads) gives a NaN m, as torch.amax does; diag stays finite."""
    n = 1029
    q, c, v, lq, _ = _ce_inputs(n + 1, 13, 128, seed=3)
    q, c, v = q[1:], c[1:], v[1:]
    for at in (0, 500, n - 1):  # lq starts 4 bytes past a 16-byte boundary: head 3, tail 2
        bad = lq.clone()[1:]
        bad[at] = float("nan")
        diag, m = _row_diag(q, c, v, bad, 1.0)
        torch.cuda.synchronize()
        assert math.isnan(m.item()) and math.isnan(fc.logsumexp_shift(bad, 20.0, 1.0).item()), at
        assert bool(torch.isfinite(diag).all())


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_ce_row_diag_takes_lq_at_any_float_offset(cuda, offset):
    """lq only 4-byte aligned (a slice of a longer vector): the shift block
    reads its scalars before the first and after the last 16-byte boundary
    one by one, so m is bit-equal to the plain shift with the max in the
    head, the body or the last element (the tail at offsets 1 and 2), and
    ce_forward's ce is within 2e-5 of the plain version's."""
    n, s = 8192 + 5, 13
    q, c, v, _, _ = _ce_inputs(n, s, 64, seed=9)
    g = torch.Generator(device="cuda").manual_seed(2)
    longer = -torch.log(torch.rand(n + 3, generator=g, device="cuda") * 1e4 + 1.0)
    for where in (0, n // 2, n - 1):
        lq = longer.clone()[offset: offset + n]
        lq[where] = -30.0
        assert lq.data_ptr() % 16 and lq.is_contiguous()
        _, m = _row_diag(q, c, v, lq, 1.0)
        torch.cuda.synchronize()
        assert _same_bits(m, fc.logsumexp_shift(lq, 20.0, 1.0)), where
    ce, _, _ = fc.ce_forward(q, c, v, lq, s, 20.0, 1.0)
    rce, _, _ = fc.ce_forward_reference(q, c, v, lq, s, 20.0, 1.0)
    fin = torch.isfinite(rce)
    assert ((ce - rce).abs()[fin] <= CE_TOL * (1 + rce.abs()[fin])).all()


def test_fused_ce_is_deterministic(cuda):
    q, c, v, lq, dce = _ce_inputs(4096, 128, 128)
    a = fc.ce_forward(q, c, v, lq, 128, 20.0, 1.0)
    b = fc.ce_forward(q, c, v, lq, 128, 20.0, 1.0)
    ga = fc.ce_backward(q, c, v, lq, a[2], dce, 128, 20.0, 1.0)
    gb = fc.ce_backward(q, c, v, lq, a[2], dce, 128, 20.0, 1.0)
    for x, y in zip(a + ga, b + gb):
        assert torch.equal(x, y)


def test_fused_ce_raises_instead_of_falling_back(cuda):
    q, c, v, lq, _ = _ce_inputs(64, 8, 16)
    before = [k.launches for k in fc.KERNELS]
    strided = torch.cat([q, q], dim=-1)[:, :16]
    with pytest.raises(ValueError, match="contiguous"):
        fc.fused_contrastive_ce(strided, c, v, lq, 8, 20.0, 0.0)
    q48, c48, v48, lq48, _ = _ce_inputs(64, 8, 48)
    with pytest.raises(ValueError, match="width"):
        fc.fused_contrastive_ce(q48, c48, v48, lq48, 8, 20.0, 0.0)
    with pytest.raises(TypeError, match="bfloat16"):
        fc.fused_contrastive_ce(q.float(), c.float(), v, lq, 8, 20.0, 0.0)
    with pytest.raises(ValueError, match="one device"):
        fc.fused_contrastive_ce(q, c.cpu(), v, lq, 8, 20.0, 0.0)
    assert [k.launches for k in fc.KERNELS] == before


def test_fused_training_step_on_card_matches_cpu(cuda):
    """One f32 training step with fused_ce on: the card (the CE kernels)
    against the CPU (their plain versions), held as the eager-CE step above."""
    d = dict(_small_config(), fused_ce=True)
    gpu = LTHMModelWrapper(LTHMModelConfig.from_dict(d))
    cpu = LTHMModelWrapper(LTHMModelConfig.from_dict(d), device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in gpu.module.state_dict().items()})
    batch, offsets = _small_batch(7), [0, 1, 3]
    before = [k.launches for k in fc.KERNELS]
    results = []
    for w in (gpu, cpu):
        w.module.zero_grad(set_to_none=True)
        loss, _, _ = w.loss_and_metrics(batch, w.init_aux_state(), True, offsets=offsets)
        loss.backward()
        results.append((loss.item(), {n: p.grad.cpu() for n, p in w.module.named_parameters() if p.grad is not None}))
    torch.cuda.synchronize()
    chunks = 2 * 3  # two loss chunks (4 users, 3 a chunk) for each of 3 heads
    assert [k.launches for k in fc.KERNELS] == [b + chunks for b in before]
    (lg, gg), (lc, gc) = results
    assert abs(lg - lc) <= 1e-4
    assert set(gg) == set(gc)
    for name in gc:
        tol = 2**-8 if ".direction_emb_" in name else 2e-4
        assert ((gg[name] - gc[name]).norm() / gc[name].norm().clamp_min(1e-30)).item() <= tol, name


# -- the CE kernels' rounded case: the eager CE (fused_ce off) on the card -----

ROUNDED_SHAPES = [
    (16384, 512, 128, 0.0, "roll"),        # lthm_prod.train's chunk: 32 users of 512 tokens
    (17000, 1000, 64, 1.0, "random"),      # 128-row blocks, a ragged last block and stage
    (8448, 264, 32, 0.5, "invalid_user"),  # the stream split, a user with every slot invalid
]


@pytest.mark.parametrize("n,s,d,beta,pattern", [*ROUNDED_SHAPES, (512, 32, 16, 1.0, "one_user")])
def test_rounded_ce_kernels_match_rounded_plain_versions(cuda, n, s, d, beta, pattern):
    """Each kernel of the rounded case against its rounded plain version on
    grid rows (every product exact in float32, so every implementation
    rounds the same S to bf16), at chip_smoke.py's tolerances: ce, lse, diag
    2e-5; rank equal; dq, dc one bf16 ulp; the same bits twice."""
    before = [k.launches for k in fc.KERNELS]
    compare_ce(fc, n, s, d, beta, pattern, rounded=True)
    assert [k.launches for k in fc.KERNELS] == before


@pytest.mark.parametrize("n,s,d,beta,pattern", ROUNDED_SHAPES)
def test_rounded_route_matches_ce_core_on_card(cuda, n, s, d, beta, pattern):
    """``fused_contrastive_ce(round_logits=True)`` on the card against the
    same call on CPU copies of its inputs (the rounded plain versions,
    ``_ce_core``'s arithmetic), forward and backward, on grid rows: ce
    within 2e-5 (1 + |ce|), the kernels' exp2 and sum order against
    torch's; rank equal; dq and dc within one bf16 ulp of the largest
    element, with chip_smoke.py's floor of 2**-16 * inv_t. One launch of
    each rounded kernel on the card, none of the unrounded ones."""
    inputs = ce_inputs(n, s, d, pattern, seed=n + d, grid=True)

    def run(q, c, v, lq, dce):
        qg, cg = q.clone().requires_grad_(), c.clone().requires_grad_()
        ce, rank = fc.fused_contrastive_ce(qg, cg, v, lq, s, 20.0, beta, round_logits=True)
        (torch.where(torch.isfinite(ce), ce, 0.0) * dce).sum().backward()
        return ce.detach(), rank, qg.grad, cg.grad

    counted = (*fc.KERNELS, *fc.ROUNDED_KERNELS)
    before = [k.launches for k in counted]
    ce, rank, dq, dc = (x.cpu() for x in run(*inputs))
    assert [k.launches - n0 for k, n0 in zip(counted, before)] == [0] * 4 + [1] * 4
    plain_ce, plain_rank, plain_dq, plain_dc = run(*(x.cpu() for x in inputs))
    fin = torch.isfinite(plain_ce)
    assert torch.equal(torch.isfinite(ce), fin)
    assert ((ce - plain_ce).abs()[fin] <= CE_TOL * (1 + plain_ce.abs()[fin])).all()
    assert torch.equal(rank, plain_rank)
    for g_, w_ in ((dq, plain_dq), (dc, plain_dc)):
        assert g_.dtype == torch.bfloat16 and bool(torch.isfinite(g_.float()).all())
        assert (g_.float() - w_.float()).abs().max().item() <= max(_bf16_ulp(w_), 2**-16 * 20.0)


@pytest.mark.parametrize("chunk,dtype", [(2, torch.float32), (1, torch.bfloat16)])
def test_eager_ce_setting_runs_the_rounded_kernels(cuda, chunk, dtype):
    """One training ``contrastive_step`` at ``fused_ce=False`` on the card, 6
    lookahead heads over 4 users in chunks of 2 (float32 heads) or 1 (bf16
    heads, whose one-user slices are strided views): 6 launches of each
    rounded kernel a chunk, none of the unrounded ones, and no call to a
    plain version (its (N, N) products); the loss finite, its gradient reaching
    the heads where a chunk holds two users (a one-user chunk has no
    negative: every other column is its own user's, so its rows weigh 0)."""
    b, s, d, heads = 4, 40, 64, 6
    g = torch.Generator(device="cuda").manual_seed(11)
    out_emb = torch.randn(b, s + 1, heads, d, generator=g, device="cuda").to(dtype).requires_grad_()
    in_emb = torch.randn(b, s, d, generator=g, device="cuda").to(dtype).requires_grad_()
    mask = torch.rand(b, s, generator=g, device="cuda") < 0.15
    ids = torch.randint(1, 2**62, (b, s), generator=g, device="cuda").masked_fill(mask, 0)
    output = {"next_token_emb": out_emb, "current_token_emb": in_emb, "current_token_mask": mask,
              "current_token_ids": ids}
    before = [k.launches for k in (*fc.KERNELS, *fc.ROUNDED_KERNELS)]
    plain_ran = AssertionError("a plain version ran on the card")
    with mock.patch.object(fc, "ce_forward_reference", side_effect=plain_ran), \
            mock.patch.object(fc, "ce_backward_reference", side_effect=plain_ran):
        loss, metrics, _ = tloss.contrastive_step(
            output, tlogq.init_logq_state(64, [0, 7], 0.01, device="cuda"), torch.tensor(3.0, device="cuda"),
            lookahead=[0, 1, 2, 3, 4, 5], temperature=0.05, beta=0.5, alpha=0.05, metrics_k_all=[1, 5],
            train_mini_batch_size=chunk, training=True, fused_ce=False, offsets=[0, 1, 2, 3, 4, 5])
        loss.backward()
    torch.cuda.synchronize()
    counted = (*fc.KERNELS, *fc.ROUNDED_KERNELS)
    assert [k.launches - n0 for k, n0 in zip(counted, before)] == [0] * 4 + [heads * (b // chunk)] * 4
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(out_emb.grad.float()).all())
    assert (out_emb.grad.float().abs().sum().item() > 0) == (chunk > 1)


# -- flash attention with the relative-position bias --------------------------

BIAS_SHAPES = [
    (4, 1025, 32, 16, 1, torch.bfloat16, True, 1025),  # the production path, 4 of 64 users
    (2, 768, 32, 16, 1, torch.bfloat16, True, 768),    # BIAS_MIN_SEQ
    (2, 1000, 32, 16, 1, torch.bfloat16, True, 1000),  # no tile multiple
    (3, 770, 32, 16, 1, torch.bfloat16, True, 1025),   # ragged, T below the window
    (2, 900, 32, 16, 1, torch.bfloat16, True, 1200),   # nk > T
    (3, 300, 32, 16, 1, torch.bfloat16, False, 300),   # non-causal; batch not a multiple of 4
    (2, 300, 32, 16, 32, torch.bfloat16, True, 300),   # MHA: FMA kernels
    (2, 300, 4, 16, 1, torch.float32, True, 300),      # float32: FMA kernels
    (2, 70, 4, 16, 4, torch.float32, False, 70),
    (2, 300, 16, 32, 1, torch.bfloat16, True, 300),    # tensor cores at hd 32 and 64
    (2, 200, 16, 64, 1, torch.bfloat16, False, 200),
]


def _bias_inputs(b, t, n_head, hd, kvh, dtype, nk, seed=0):
    """q, k, v, a table whose entries are not bf16 values (so the kernel's
    rounding shows), and a cotangent."""
    q, k, v = _qkv(b, t, n_head, hd, kvh, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    table = torch.randn(2 * nk + 1, n_head, generator=g, device="cuda")
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    return q, k, v, table, do


@pytest.mark.parametrize("b,t,n_head,hd,kvh,dtype,causal,nk", BIAS_SHAPES)
def test_flash_bias_kernels_match_plain_versions(cuda, b, t, n_head, hd, kvh, dtype, causal, nk):
    """o and lse at the flash tolerances; dq, dk, dv in f32 at 2e-4 abs + rel,
    in bf16 within one bf16 ulp of the largest element (a sum in another order
    may land on the neighbouring bf16 value); the table gradient (f32 sums of
    the unrounded ds in another order) within 2e-4 of its largest entry."""
    _check_bias_kernels(b, t, n_head, hd, kvh, dtype, causal, nk)


@pytest.mark.parametrize(
    "b,t,causal,nk",
    [
        (64, 1025, True, 1025),   # the production path: 64 users
        (45, 768, True, 768),     # a last block of fewer batch rows
        (20, 1025, False, 1024),  # non-causal
    ],
)
def test_flash_bias_dkv_blocks_of_several_batch_rows(cuda, b, t, causal, nk):
    """Where the (key block, batch row) items exceed what one wave of dK/dV
    blocks holds, a block of the persistent grid walks several (reloading
    K/V, restarting dK/dV, adding each item's table gradient into its one
    slice): held to the plain versions, taken over 4 batch rows at a time, as
    above."""
    q, k, _ = _qkv(b, t, 32, 16, 1, torch.bfloat16)
    assert fa.bias_dkv_items_per_block(q, k, 32) > 1
    _check_bias_kernels(b, t, 32, 16, 1, torch.bfloat16, causal, nk)


def _check_bias_kernels(b, t, n_head, hd, kvh, dtype, causal, nk):
    q, k, v, table, do = _bias_inputs(b, t, n_head, hd, kvh, dtype, nk)
    before = [kern.launches for kern in (fa.FLASH_BIAS_FWD, fa.FLASH_BIAS_DQ, fa.FLASH_BIAS_DKV)]
    o, lse = fa.fused_flash_attention_bias_fwd(q, k, v, table, n_head, nk, causal)
    got = fa.fused_flash_attention_bias_bwd(q, k, v, table, o, lse, do, n_head, nk, causal)
    torch.cuda.synchronize()
    assert [kern.launches for kern in (fa.FLASH_BIAS_FWD, fa.FLASH_BIAS_DQ, fa.FLASH_BIAS_DKV)] == [
        x + 1 for x in before
    ]
    ro, rl, want = bias_reference(fa, q, k, v, table, o, lse, do, n_head, nk, causal, 4)
    assert o.dtype == dtype and (o.float() - ro.float()).abs().max().item() <= o_tolerance(dtype, ro)
    assert (lse - rl).abs().max().item() <= LSE_TOL
    for name, g_, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert g_.dtype == dtype and g_.shape == w.shape, name
        err = (g_.float() - w.float()).abs()
        tol = _bf16_ulp(w) if dtype == torch.bfloat16 else bwd_tolerance(dtype, w)
        assert bool((err <= tol).all()), f"{name}: max err {err.max().item()}"
    dtable, wtable = got[3], want[3]
    assert dtable.shape == table.shape and dtable.dtype == torch.float32
    assert (dtable - wtable).abs().max().item() <= 2e-4 * max(1.0, wtable.abs().max().item())


@pytest.mark.parametrize(
    "b,t,n_head,hd,causal,nk",
    [
        (64, 1025, 32, 16, True, 1025),   # the production path
        (45, 1025, 32, 16, True, 1025),
        (20, 1026, 32, 16, False, 1026),  # non-causal, a ragged last key tile
        (4, 768, 32, 16, True, 768),      # BIAS_MIN_SEQ
        (4, 1, 32, 16, True, 1),          # one row
        (2, 1025, 16, 16, True, 1025),    # 1 to 4 groups of 16 heads: the one-pass kernel
        (2, 1026, 48, 16, True, 1030),
        (2, 768, 64, 16, False, 768),
        (2, 770, 32, 32, True, 1025),     # hd 32 and 64, T below the window
        (2, 300, 128, 64, True, 300),
        (2, 300, 256, 16, True, 300),     # 16 groups: the two-pass tensor-core kernel
    ],
)
def test_flash_bias_fwd_matches_plain_version_at_its_arithmetic(cuda, b, t, n_head, hd, causal, nk):
    """The bias forward against its plain version in the kernel's own
    softmax arithmetic (``bias_kernel_softmax``: 16-key chunks and exp2 on
    the one-pass kernel), over 4 batch rows at a time, with table entries
    that are not bf16 values: o within 2**-8 of the largest output (a sum in
    another order may land on the neighbouring bf16 value), lse within 1e-4;
    one launch a call, and the same bits twice."""
    q, k, v, table, _ = _bias_inputs(b, t, n_head, hd, 1, torch.bfloat16, nk, seed=t + n_head)
    before = fa.FLASH_BIAS_FWD.launches
    o, lse = fa.fused_flash_attention_bias_fwd(q, k, v, table, n_head, nk, causal)
    o2, lse2 = fa.fused_flash_attention_bias_fwd(q, k, v, table, n_head, nk, causal)
    torch.cuda.synchronize()
    assert fa.FLASH_BIAS_FWD.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    arith = fa.bias_kernel_softmax(q, k, n_head)
    parts = [fa.fused_flash_attention_bias_reference(q[i:i + 4], k[i:i + 4], v[i:i + 4], table, n_head, nk, causal,
                                                     **arith) for i in range(0, b, 4)]
    ro, rl = torch.cat([x[0] for x in parts]), torch.cat([x[1] for x in parts])
    assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o.float()).all())
    assert (o.float() - ro.float()).abs().max().item() <= o_tolerance(torch.bfloat16, ro)
    assert (lse - rl).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize(
    "b,t,n_head,hd,causal,nk",
    [
        (64, 1025, 32, 16, True, 1025),   # the production path
        (45, 1025, 32, 16, True, 1025),
        (20, 1026, 32, 16, False, 1026),  # non-causal, a ragged last key tile
        (4, 768, 32, 16, True, 768),      # BIAS_MIN_SEQ
        (4, 1, 32, 16, True, 1),          # one row
        (2, 1025, 16, 16, True, 1025),    # 1 to 8 groups of 16 heads: the tensor-core dQ kernel
        (2, 1026, 48, 16, True, 1030),
        (2, 768, 64, 16, False, 768),
        (2, 770, 32, 32, True, 1025),     # hd 32 and 64, T below the window
        (2, 300, 128, 64, True, 300),
        (3, 1025, 128, 16, True, 1025),
        (2, 300, 256, 16, True, 300),     # 16 groups: mqa_mma_dq_kernel
    ],
)
def test_flash_bias_dq_matches_plain_version_at_its_arithmetic(cuda, b, t, n_head, hd, causal, nk):
    """The bias dQ kernel against the plain backward's dq with p taken as the
    kernel takes it (``bias_kernel_softmax``'s ``exp2``: ex2 on the
    tensor-core dQ kernel, exp on mqa_mma_dq_kernel), over 4 batch rows at a
    time, with table entries that are not bf16 values: within one bf16 ulp
    of the largest element (a sum in another order may land on the
    neighbouring bf16 value), and at T = 1 only, where the gradient
    vanishes, a floor of 2**-16 (one key, p = 1, so dp - D is the difference
    of two f32 sums of the same hd products, and both sides hold only its
    rounding); one launch a call, and the same bits twice."""
    q, k, v, table, do = _bias_inputs(b, t, n_head, hd, 1, torch.bfloat16, nk, seed=t + 3 * n_head)
    o, lse = fa.fused_flash_attention_bias_fwd(q, k, v, table, n_head, nk, causal)
    before = fa.FLASH_BIAS_DQ.launches
    dq = fa.fused_flash_attention_bias_bwd(q, k, v, table, o, lse, do, n_head, nk, causal)[0]
    dq2 = fa.fused_flash_attention_bias_bwd(q, k, v, table, o, lse, do, n_head, nk, causal)[0]
    torch.cuda.synchronize()
    assert fa.FLASH_BIAS_DQ.launches == before + 2
    assert torch.equal(dq, dq2)
    exp2 = fa.bias_kernel_softmax(q, k, n_head)["exp2"]
    assert exp2 == (n_head <= 128)
    want = torch.cat([fa.fused_flash_attention_bias_bwd_reference(
        q[i:i + 4], k[i:i + 4], v[i:i + 4], table, o[i:i + 4], lse[i:i + 4], do[i:i + 4], n_head, nk, causal,
        exp2=exp2)[0] for i in range(0, b, 4)])
    assert dq.dtype == torch.bfloat16 and bool(torch.isfinite(dq.float()).all())
    tol = max(_bf16_ulp(want), 2**-16) if t == 1 else _bf16_ulp(want)
    assert (dq.float() - want.float()).abs().max().item() <= tol


def test_flash_bias_dq_refused_launch_raises(cuda):
    """A shape the kernels refuse (more batch rows than a grid dimension
    takes): the launch raises, counts nothing, and nothing falls back to the
    plain version."""
    q, k, v, table, do = _bias_inputs(65536, 1, 16, 16, 1, torch.bfloat16, 1)
    o, lse = torch.zeros_like(q), torch.zeros(q.shape[0], 1, 16, device="cuda")
    before = [kern.launches for kern in (fa.FLASH_BIAS_DQ, fa.FLASH_BIAS_DKV)]
    with pytest.raises(ValueError, match="flash_bias_dq: the kernel does not take this shape"):
        fa.fused_flash_attention_bias_bwd(q, k, v, table, o, lse, do, 16, 1, True)
    assert [kern.launches for kern in (fa.FLASH_BIAS_DQ, fa.FLASH_BIAS_DKV)] == before


def test_flash_bias_is_deterministic(cuda):
    q, k, v, table, do = _bias_inputs(8, 1025, 32, 16, 1, torch.bfloat16, 1025, seed=3)
    a = fa.fused_flash_attention_bias_fwd(q, k, v, table, 32, 1025, True)
    b = fa.fused_flash_attention_bias_fwd(q, k, v, table, 32, 1025, True)
    ga = fa.fused_flash_attention_bias_bwd(q, k, v, table, *a, do, 32, 1025, True)
    gb = fa.fused_flash_attention_bias_bwd(q, k, v, table, *a, do, 32, 1025, True)
    for x, y in zip(a + ga, b + gb):
        assert torch.equal(x, y)


def test_flash_bias_raises_instead_of_falling_back(cuda):
    q, k, v, table, do = _bias_inputs(1, 16, 2, 16, 1, torch.bfloat16, 16)
    kernels = (fa.FLASH_BIAS_FWD, fa.FLASH_BIAS_DQ, fa.FLASH_BIAS_DKV)
    before = [kern.launches for kern in kernels]
    with pytest.raises(ValueError, match="exceeds bias table"):
        fa.fused_flash_attention_bias(q, k, v, table[:20], 2, 16, True)
    with pytest.raises(ValueError, match="float32"):
        fa.fused_flash_attention_bias(q, k, v, table.bfloat16(), 2, 16, True)
    with pytest.raises(ValueError, match="device"):
        fa.fused_flash_attention_bias(q, k, v, table.cpu(), 2, 16, True)
    strided = torch.cat([q, q], dim=-1)[..., : q.shape[-1]]
    with pytest.raises(ValueError, match="contiguous"):
        fa.fused_flash_attention_bias(strided, k, v, table, 2, 16, True)
    assert [kern.launches for kern in kernels] == before


def test_flash_bias_autograd_launches_each_kernel_once(cuda):
    q, k, v, table, do = _bias_inputs(2, 800, 32, 16, 1, torch.bfloat16, 800)
    q, k, v, table = (x.requires_grad_() for x in (q, k, v, table))
    kernels = (fa.FLASH_BIAS_FWD, fa.FLASH_BIAS_DQ, fa.FLASH_BIAS_DKV, fa.FLASH_FWD, fa.FLASH_BWD)
    before = [kern.launches for kern in kernels]
    o = fa.fused_flash_attention_bias(q, k, v, table, 32, 800, True)
    o.backward(do)
    torch.cuda.synchronize()
    assert [kern.launches for kern in kernels] == [x + d for x, d in zip(before, (1, 1, 1, 0, 0))]
    assert all(bool(torch.isfinite(x.grad.float()).all()) for x in (q, k, v, table))
