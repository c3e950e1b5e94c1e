"""The LFM2-8B-A1B backbone of the port (``nn/lfm2.py``, ``backbone:
lfm2_moe``) against the benchmark's plain reference
(``benchmark/reference/lthm_lfm2.py``, in float32) on seeded random
weights, at a tiny size on the CPU: d=64, 4 query heads
over 2 key/value heads, 8 experts top-2 of width 32, layers [conv, conv,
attn, conv, conv, attn] with 2 dense. Forward and gradients of each mixer,
the routed MoE against its per-expert loop, the whole LTHM's serving
vectors and one training step, the configuration's checks, and the
benchmark configuration's published widths.

The card case compares the routed MoE's grouped products (bf16, CUDA)
with its loop over experts:

    python -m pytest --noconftest -m cuda tests/test_torch_lfm2_moe.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import lthm_lfm2 as ref
from recommendations_tpu_torch.models.lthm.config import LFM2MoEConfig, LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.nn import lfm2
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState

ROOT = Path(__file__).resolve().parent.parent
LAYERS = ["conv", "conv", "full_attention", "conv", "conv", "full_attention"]
F32 = ref.Precision("f32")
# float32 on both sides, the same products in another order
FWD_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def tiny_backbone(**over):
    tc = dict(backbone="lfm2_moe", hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
              intermediate_size=96, moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2,
              num_dense_layers=2, layer_types=list(LAYERS), conv_L_cache=3, rope_theta=1e6, norm_eps=1e-5,
              norm_topk_prob=True, routed_scaling_factor=1.0, use_expert_bias=True,
              enable_gradient_checkpointing=True, remat_policy="dots_no_batch")
    tc.update(over)
    return tc


def tiny_config(**over):
    """LTHM around the tiny backbone, float32, context 24."""
    return dict(
        features={"defaults": {}},
        compute_dtype="float32",
        transformer_config=tiny_backbone(**over),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=64, item_emb_dim=32, norm_bins=8, norm_threshold=0.05,
            detach_item_tower=True,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 16}],
            latent_model_config={"vocab_size_latent": 5000, "num_shifts_latent": 4, "normalize_embedding": True},
        ),
        log_q_config={"num_buckets": 64, "hash_offsets": [0, 7], "alpha": 0.05, "p_init": 0.001, "beta": 0.0},
        lookahead=[0, 2],
        context_width=24,
        softmax_temperature=0.05,
        table_optimizer="frozen",
        train_mini_batch_size=2,
        lr=1e-3,
        weight_decay=1e-3,
        betas=[0.9, 0.95],
    )


def tiny_batch(b=4, s=30, seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, 2**62, size=(b, s)).astype(np.int64)
    ids[:, -3:] = 0
    return {
        "product_ids": torch.from_numpy(ids),
        "labels": torch.from_numpy(rs.randint(0, 4, size=(b, s)).astype(np.float32)),
        "timestamps": torch.from_numpy(rs.randint(1_600_000_000, 1_700_000_000, size=(b, s)).astype(np.float32)),
    }


def wrapper(cfg=None, seed=1):
    """The port at float32 with the LSH products in float32 too (the
    reference's), and a nonzero expert bias in every MoE layer."""
    w = LTHMModelWrapper(LTHMModelConfig.from_dict(cfg or tiny_config()), device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 100)
    for m in w.module.modules():
        if type(m).__name__ == "CosineVectorEmbedding":
            m.compute_dtype = torch.float32
        if isinstance(m, lfm2.RoutedMoE):
            m.expert_bias.copy_(0.05 * torch.randn(m.expert_bias.shape, generator=gen))
    return w


def weights_of(module, prefix=""):
    return {prefix + k: v.detach().clone() for k, v in module.state_dict().items()}


def grads_close(got, want, **tol):
    for name, (g, r) in enumerate(zip(got, want)):
        assert torch.allclose(g, r, **tol), (name, (g - r).abs().max().item())


def test_short_conv_matches_reference_and_reads_no_later_position():
    gen = torch.Generator().manual_seed(3)
    conv = lfm2.ShortConv(64, 3, gen)
    x = torch.randn(3, 9, 64, generator=gen, requires_grad=True)
    got = conv(x)
    w = weights_of(conv, "c.")
    want = ref.short_conv(x, {k: v.requires_grad_(True) for k, v in w.items()}, "c.", 3, F32)
    assert torch.allclose(got, want, **FWD_TOL)
    # the first two positions read zeros before the start: they equal the
    # convolution of the sequence cut to them
    assert torch.allclose(conv(x[:, :1]), got[:, :1], **FWD_TOL)
    assert torch.allclose(conv(x[:, :2]), got[:, :2], **FWD_TOL)
    later = x.detach().clone()
    later[:, 5:] += 1.0
    assert torch.allclose(conv(later)[:, :5], got[:, :5].detach(), **FWD_TOL)
    r = torch.randn(got.shape, generator=gen)
    params = [x, conv.in_proj.weight, conv.weight, conv.out_proj.weight]
    g_got = torch.autograd.grad((got * r).sum(), params)
    ref_params = [x] + [w[k] for k in ("c.in_proj.weight", "c.weight", "c.out_proj.weight")]
    g_want = torch.autograd.grad((want * r).sum(), ref_params)
    grads_close(g_got, g_want, **GRAD_TOL)


@pytest.mark.parametrize("kv_heads", [1, 2, 4])
def test_gqa_attention_with_qk_norm_and_rope_matches_reference(kv_heads):
    gen = torch.Generator().manual_seed(kv_heads)
    attn = lfm2.GQAttention(64, 4, kv_heads, 1e-5, gen)
    with torch.no_grad():
        for norm in (attn.q_layernorm, attn.k_layernorm):
            norm.weight.add_(0.1 * torch.randn(norm.weight.shape, generator=gen))
    x = torch.randn(2, 11, 64, generator=gen, requires_grad=True)
    cos, sin = lfm2.rope_tables(11, 16, 1e6, "cpu")
    got = attn(x, cos, sin)
    w = {k: v.requires_grad_(True) for k, v in weights_of(attn, "a.").items()}
    tc = dict(num_attention_heads=4, num_key_value_heads=kv_heads, norm_eps=1e-5, rope_theta=1e6)
    want = ref.attention(x, w, "a.", tc, F32, grad=False)
    assert torch.allclose(got, want, **FWD_TOL)
    r = torch.randn(got.shape, generator=gen)
    names = ["q_proj.weight", "k_proj.weight", "v_proj.weight", "out_proj.weight", "q_layernorm.weight",
             "k_layernorm.weight"]
    mods = {"q_proj.weight": attn.q_proj.weight, "k_proj.weight": attn.k_proj.weight,
            "v_proj.weight": attn.v_proj.weight, "out_proj.weight": attn.out_proj.weight,
            "q_layernorm.weight": attn.q_layernorm.weight, "k_layernorm.weight": attn.k_layernorm.weight}
    g_got = torch.autograd.grad((got * r).sum(), [x] + [mods[n] for n in names])
    g_want = torch.autograd.grad((want * r).sum(), [x] + [w["a." + n] for n in names])
    grads_close(g_got, g_want, **GRAD_TOL)


def moe_case(seed=5, n=40):
    gen = torch.Generator().manual_seed(seed)
    moe = lfm2.RoutedMoE(64, 32, 8, 2, gen)
    with torch.no_grad():
        moe.expert_bias.copy_(0.05 * torch.randn(8, generator=gen))
        moe.expert_bias[3] = -100.0  # expert 3 receives no token
    x = torch.randn(n, 64, generator=gen, requires_grad=True)
    tc = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=32, norm_topk_prob=True,
              routed_scaling_factor=1.0)
    return gen, moe, x, tc


def test_routed_moe_matches_the_per_expert_loop_with_an_idle_expert():
    gen, moe, x, tc = moe_case()
    choice = moe.route(x)
    assert not (choice == 3).any() and choice.shape == (40, 2)
    got = moe(x)
    w = {"gate": moe.gate.detach().clone().requires_grad_(True), "expert_bias": moe.expert_bias,
         "w13": moe.w13.detach().clone().requires_grad_(True), "w2": moe.w2.detach().clone().requires_grad_(True)}
    scores = []
    want = ref.routed_moe(x, w, "", tc, F32, on_route=lambda _, sc: scores.append(sc))
    assert torch.equal(torch.topk(scores[0] + moe.expert_bias, 2, dim=-1).indices, choice)
    assert torch.allclose(got, want, **FWD_TOL)
    r = torch.randn(got.shape, generator=gen)
    g_got = torch.autograd.grad((got * r).sum(), [x, moe.gate, moe.w13, moe.w2])
    g_want = torch.autograd.grad((want * r).sum(), [x, w["gate"], w["w13"], w["w2"]])
    grads_close(g_got, g_want, **GRAD_TOL)
    assert g_got[2][3].abs().max() == 0 and g_got[3][3].abs().max() == 0  # the idle expert's


def test_routed_moe_counts_every_row_once():
    _, moe, x, _ = moe_case(seed=6, n=50)
    scores = torch.sigmoid(x.detach() @ moe.gate.detach().t())
    r = lfm2._Routing(scores, moe.expert_bias, 2)
    assert int(r.counts.sum()) == 50 * 2 and int(r.counts[3]) == 0
    assert torch.equal(r.ends, torch.cumsum(r.counts, 0).to(torch.int32))
    # each (token, slot) row sits once in the expert order, at its place
    flat = r.choice.reshape(-1)
    assert torch.equal(torch.sort(r.order).values, torch.arange(100))
    assert torch.equal(flat[r.order], torch.sort(flat, stable=True).values)
    assert torch.equal(r.order[r.place.reshape(-1)], torch.arange(100))


def test_lthm_lfm2_user_encoder_matches_reference():
    w = wrapper()
    batch = tiny_batch()
    got = w.inference_models()["user_encoder"](batch)["user_emb"]
    cfg = tiny_config()
    want = ref.user_embeddings(cfg, weights_of(w.module), batch, F32)
    assert got.shape == (4, 32)
    assert torch.allclose(got, want, atol=3e-5)


def test_lthm_lfm2_train_step_matches_reference():
    """One step: the loss, every leaf's gradient norm and its change (the
    port's CE takes bf16 operands in any compute dtype, the reference's are
    float32: about 1e-4 of the loss, 1e-3 of a leaf's gradient)."""
    cfg = tiny_config()
    w = wrapper(cfg)
    start = weights_of(w.module)
    state = TrainState.create(w, seed=2)
    batch = tiny_batch(seed=4)
    # the offsets the reference draws from its seed
    offsets = ref.base.sample_offsets(torch.Generator().manual_seed(6), cfg["lookahead"])
    loss, _ = train_step(state, batch, offsets=offsets)
    named = dict(w.module.named_parameters())
    opt = state.optimizer.inner
    grad = {n: (opt.state[p]["exp_avg"].norm() / 0.1).item() for n, p in named.items() if p in opt.state}
    change = {n: (p.detach() - start[n]).norm().item() for n, p in named.items() if p in opt.state}
    want = ref.train(cfg, start, [batch], 6, F32)
    assert abs(loss.item() - want["losses"][0]) <= 5e-4 * abs(want["losses"][0])
    assert set(grad) == set(want["grad_norms"])
    median = float(np.median(list(want["grad_norms"].values())))
    for n, g in grad.items():
        assert abs(g - want["grad_norms"][n]) <= 3e-3 * max(want["grad_norms"][n], median), n
        assert abs(change[n] - want["change_norms"][n]) <= 0.02 * max(want["change_norms"][n], 1e-4), n


def test_remat_keeps_the_gradients_and_reruns_no_count():
    """The stack under remat (the custom MoE function inside the selective
    checkpoint) gives the gradients of the stack without it."""
    cfgs = [LFM2MoEConfig.from_dict(tiny_backbone(enable_gradient_checkpointing=r)) for r in (True, False)]
    stacks = [lfm2.LFM2Stack(c, torch.Generator().manual_seed(8)) for c in cfgs]
    x = torch.randn(2, 13, 64, generator=torch.Generator().manual_seed(9))
    grads = []
    for s in stacks:
        out = s(x)
        out.square().sum().backward()
        grads.append([p.grad for p in s.parameters()])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-5)


def test_from_dict_rejects_unknown_keys_and_backbones():
    bad = tiny_config()
    bad["transformer_config"]["attn_config"] = {"n_head": 4}
    with pytest.raises(TypeError, match="unknown fields"):
        LTHMModelConfig.from_dict(bad)
    with pytest.raises(ValueError, match="backbone"):
        LTHMModelConfig.from_dict(tiny_config(backbone="mamba"))
    with pytest.raises(ValueError, match="layer_types"):
        LTHMModelConfig.from_dict(tiny_config(layer_types=["conv", "sliding_attention"]))
    with pytest.raises(ValueError, match="num_hidden_layers"):
        LTHMModelConfig.from_dict(tiny_config(num_hidden_layers=24))
    for over in ({"use_expert_bias": False}, {"norm_topk_prob": False}, {"routed_scaling_factor": 2.5}):
        with pytest.raises(NotImplementedError):
            LTHMModelConfig.from_dict(tiny_config(**over))
    cfg = LTHMModelConfig.from_dict(tiny_config())
    assert isinstance(cfg.transformer_config, LFM2MoEConfig) and cfg.emb_dim == 64


def leaf_count(tc: dict) -> int:
    """The backbone's trainable parameters, from the layer shapes."""
    d, e, f, ff = tc["hidden_size"], tc["num_experts"], tc["moe_intermediate_size"], tc["intermediate_size"]
    kv = tc["num_key_value_heads"] * d // tc["num_attention_heads"]
    total = d
    for i, kind in enumerate(tc["layer_types"]):
        total += 2 * d
        total += (2 * d * d + 2 * d * kv + 2 * d // tc["num_attention_heads"]) if kind == "full_attention" \
            else (4 * d * d + d * tc["conv_L_cache"])
        total += 3 * d * ff if i < tc["num_dense_layers"] else e * d + 3 * e * d * f
    return total


def test_parameter_count_matches_the_layer_shapes():
    w = wrapper()
    stack = w.module.query_tower.transformer
    assert sum(p.numel() for p in stack.parameters()) == leaf_count(tiny_backbone())


# LFM2-8B-A1B's published config.json
# (https://huggingface.co/LiquidAI/LFM2-8B-A1B/blob/main/config.json)
PUBLISHED = {
    "conv_L_cache": 3, "hidden_size": 2048, "intermediate_size": 7168, "max_position_embeddings": 128000,
    "moe_intermediate_size": 1792, "norm_eps": 1e-05, "num_attention_heads": 32, "num_dense_layers": 2,
    "num_experts": 32, "num_experts_per_tok": 4, "num_hidden_layers": 24, "num_key_value_heads": 8,
    "rope_theta": 1000000, "routed_scaling_factor": 1, "vocab_size": 65536, "conv_bias": False,
    "norm_topk_prob": True, "use_expert_bias": True, "model_type": "lfm2_moe",
    "layer_types": ["conv", "conv", "full_attention", "conv", "conv", "conv", "full_attention", "conv", "conv",
                    "conv", "full_attention", "conv", "conv", "conv", "full_attention", "conv", "conv", "conv",
                    "full_attention", "conv", "conv", "full_attention", "conv", "conv"],
}
WIDTHS = ("hidden_size", "intermediate_size", "moe_intermediate_size", "num_attention_heads",
          "num_key_value_heads", "num_experts", "num_experts_per_tok", "num_dense_layers", "conv_L_cache",
          "rope_theta", "norm_eps", "routed_scaling_factor", "norm_topk_prob", "use_expert_bias")


def test_benchmark_configuration_keeps_the_published_widths():
    """The file holds the published config's keys at its top level, cut
    only where ``reduced`` says (the first 8 layers), and the model it runs
    has those widths."""
    config = json.loads((ROOT / "benchmark" / "configs" / "lthm_lfm2moe.json").read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == "lthm_lfm2moe"]
    # the cuts, then what LTHM changes around the block (the file's ``changed``)
    assert entry["reduced"] == ["num_hidden_layers", "layer_types", "vocab_size", "max_position_embeddings",
                                "wpe", "compute_dtype"]
    for k, v in PUBLISHED.items():
        if k not in ("num_hidden_layers", "layer_types"):
            assert config[k] == v, k
    assert config["num_hidden_layers"] == 8 and config["layer_types"] == PUBLISHED["layer_types"][:8]
    tc = config["model_config"]["transformer_config"]
    for k in WIDTHS:
        assert tc[k] == PUBLISHED[k], k
    assert tc["layer_types"] == config["layer_types"] and tc["num_hidden_layers"] == 8
    cfg = LTHMModelConfig.from_dict(config["model_config"])
    assert cfg.emb_dim == 2048 and cfg.context_width == 1024


@pytest.mark.cuda
def test_routed_moe_grouped_products_on_the_card_match_the_loop():
    """bf16 on the card: the grouped products and the written-out backward
    against the per-expert loop in float32 on the same bf16-rounded
    weights, at the published widths and a few thousand rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    moe = lfm2.RoutedMoE(2048, 1792, 32, 4, gen, dtype=torch.bfloat16)
    with torch.no_grad():
        moe.expert_bias.copy_(0.02 * torch.randn(32, generator=gen, device=dev))
        moe.expert_bias[7] = -100.0
        for p in (moe.w13, moe.w2):
            p.copy_(p.to(torch.bfloat16).float())
    # bf16-exact inputs: the router reads the same float32 values on both sides
    x = torch.randn(4096, 2048, generator=gen, device=dev).to(torch.bfloat16).float().requires_grad_(True)
    got = moe(x)
    tc = dict(num_experts=32, num_experts_per_tok=4, moe_intermediate_size=1792, norm_topk_prob=True,
              routed_scaling_factor=1.0)
    w = {"gate": moe.gate.detach().clone().requires_grad_(True), "expert_bias": moe.expert_bias,
         "w13": moe.w13.detach().clone().requires_grad_(True), "w2": moe.w2.detach().clone().requires_grad_(True)}
    with ref.base.exact_f32():
        want = ref.routed_moe(x, w, "", tc, F32)
        r = torch.randn(got.shape, generator=gen, device=dev)
        g_want = torch.autograd.grad((want * r).sum(), [w["gate"], w["w13"], w["w2"]])
    g_got = torch.autograd.grad((got.float() * r).sum(), [moe.gate, moe.w13, moe.w2])
    err = (got.float() - want).norm() / want.norm()
    assert err < 1e-2, err.item()
    for a, b in zip(g_got, g_want):
        assert (a - b).norm() / b.norm() < 2e-2
    assert g_got[1][7].abs().max() == 0


def test_benchmark_weights_and_reference_agree_with_the_port_and_this_reference():
    """The benchmark's files for the cell at the tiny size: its weights load
    strictly into the port, and its reference's serving vectors are the
    port's."""
    from benchmark.models import lthm_lfm2 as bench_model

    cfg = tiny_config()
    weights = bench_model.make_weights(cfg, 4_000_000_007, "cpu")
    assert weights["query_tower.transformer.block_3.feed_forward.expert_bias"].abs().max() > 0
    w = bench_model.build_program(cfg, weights, "cpu")
    for m in w.module.modules():
        if type(m).__name__ == "CosineVectorEmbedding":
            m.compute_dtype = torch.float32
    batch = tiny_batch(seed=7)
    served = bench_model.serve_fn(w)(batch)["user_emb"]
    want = bench_model.reference_serve(cfg, weights, batch)
    assert torch.allclose(served, want, atol=3e-5)


def test_benchmark_expert_bias_evens_the_loads():
    """``even_loads`` takes scores whose first experts lead every row to
    about N k / E rows an expert, and the benchmark's weights carry such a
    bias in every MoE layer, the same on a second call, the other leaves
    as drawn."""
    from benchmark.models import lthm_lfm2 as bench_model

    gen = torch.Generator().manual_seed(3)
    scores = torch.sigmoid(torch.randn(4000, 8, generator=gen) + torch.linspace(3.0, 0.0, 8))

    def ratio(bias):
        n = torch.bincount(torch.topk(scores + bias, 2, dim=-1).indices.reshape(-1), minlength=8).double()
        return float(n.max() / n.mean())

    assert ratio(torch.zeros(8)) > 2.5
    assert ratio(bench_model.even_loads(scores, torch.zeros(8), 2)) < 1.05
    cfg = tiny_config()
    drawn = bench_model.make_weights(cfg, 4_000_000_011, "cpu", balance=False)
    first = bench_model.make_weights(cfg, 4_000_000_011, "cpu")
    again = bench_model.make_weights(cfg, 4_000_000_011, "cpu")
    biases = [n for n in drawn if n.endswith("expert_bias")]
    assert len(biases) == 4
    for n in drawn:
        assert torch.equal(first[n], again[n]), n
        assert torch.equal(first[n], drawn[n]) != (n in biases), n
