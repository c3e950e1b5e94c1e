"""The port's ``lthm/...`` profiler ranges (``core/spans.py``): which ranges a
training step and a serving call open, how they nest, and that outside a
profiler no range is entered at all.

The CPU cases run a tiny LTHM (2 layers, d=64); the ``cuda`` case checks on
the card that the bias kernels' backward is launched inside
``lthm/attention_backward``:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from recommendations_tpu_torch.core import spans
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.nn import transformer as ttr
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState

LAYERS = 2


def tiny_config(remat=True):
    """2 layers, d=64, MQA with 4 heads, context 24, two lookahead heads."""
    return dict(
        features={"defaults": {}},
        compute_dtype="float32",
        transformer_config=dict(
            rotator_config={"ff_mult": 4}, is_causal=True, num_layers=LAYERS, use_flash_attention=True,
            enable_gradient_checkpointing=remat,
            attn_config=dict(n_head=4, n_embd=64, attn_type="multi_query", dropout=0.0, attn_dropout=0.0,
                             bias=False),
        ),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=64, product_emb_dim=32, norm_bins=8,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 16}],
            latent_model_config={"vocab_size_latent": 5000, "num_shifts_latent": 4, "normalize_embedding": True},
        ),
        log_q_config={"num_buckets": 64, "hash_offsets": [0, 7]},
        lookahead=[0, 2],
        context_width=24,
        table_optimizer="frozen",
        lr=1e-3,
    )


def tiny_batch(b=4, s=30):
    rs = np.random.RandomState(0)
    ids = rs.randint(1, 2**62, size=(b, s)).astype(np.int64)
    ids[:, -3:] = 0
    return {
        "product_ids": ids,
        "labels": rs.randint(0, 4, size=(b, s)).astype(np.float32),
        "timestamps": rs.randint(1_600_000_000, 1_700_000_000, size=(b, s)).astype(np.float32),
    }


def wrapper(remat=True):
    return LTHMModelWrapper(LTHMModelConfig.from_dict(tiny_config(remat)), device="cpu", seed=1)


def ranges(prof):
    """The ``lthm/`` ranges the profile recorded, as (name, start us, end us)."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith("lthm/")]


def within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_train_step_opens_every_layer_and_remat_reruns_attention_and_mlp():
    """Every range of a step lies in ``lthm/step``; the layers in their phases."""
    state = TrainState.create(wrapper(remat=True))
    batch = tiny_batch()
    train_step(state, batch, offsets=[0, 1])  # the first step's lazy set-up outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, batch, offsets=[0, 1])
    got = ranges(prof)
    count = Counter(name for name, _, _ in got)
    for name in ("lthm/inputs", "lthm/forward", "lthm/product_tower", "lthm/loss", "lthm/logq",
                 "lthm/loss_metrics", "lthm/ce_backward", "lthm/backward", "lthm/optimizer"):
        assert count[name] >= 1, (name, count)
    (step,) = [r for r in got if r[0] == "lthm/step"]
    assert all(within(r, step) for r in got)
    # once in the forward, once in the backward's rerun
    assert count["lthm/attention"] == 2 * LAYERS and count["lthm/mlp"] == 2 * LAYERS, count
    (forward,) = [r for r in got if r[0] == "lthm/forward"]
    (backward,) = [r for r in got if r[0] == "lthm/backward"]
    (loss,) = [r for r in got if r[0] == "lthm/loss"]
    for layer in ("lthm/attention", "lthm/mlp"):
        assert sum(within(r, forward) for r in got if r[0] == layer) == LAYERS
        assert sum(within(r, backward) for r in got if r[0] == layer) == LAYERS
    # the flash op's backward (its plain version on the CPU), once a layer
    attn_bwd = [r for r in got if r[0] == "lthm/attention_backward"]
    assert len(attn_bwd) == LAYERS and all(within(r, backward) for r in attn_bwd)
    assert all(within(r, forward) for r in got if r[0] == "lthm/product_tower")
    assert all(within(r, loss) for r in got if r[0] in ("lthm/logq", "lthm/loss_metrics"))


def test_train_step_without_remat_opens_attention_and_mlp_once():
    state = TrainState.create(wrapper(remat=False))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, tiny_batch(), offsets=[0, 1])
    count = Counter(name for name, _, _ in ranges(prof))
    assert count["lthm/attention"] == LAYERS and count["lthm/mlp"] == LAYERS, count


def test_user_encoder_opens_serve_around_inputs_and_forward():
    encode = wrapper().inference_models()["user_encoder"]
    batch = tiny_batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        emb = encode(batch)["user_emb"]
    assert emb.shape == (4, 32)
    got = ranges(prof)
    (serve,) = [r for r in got if r[0] == "lthm/serve"]
    (inputs,) = [r for r in got if r[0] == "lthm/inputs"]
    (forward,) = [r for r in got if r[0] == "lthm/forward"]
    assert within(inputs, serve) and within(forward, serve) and inputs[2] <= forward[1]
    for layer in ("lthm/product_tower", "lthm/attention", "lthm/mlp"):
        inside = [r for r in got if r[0] == layer]
        assert len(inside) == (1 if layer == "lthm/product_tower" else LAYERS), layer
        assert all(within(r, forward) for r in inside), layer
    # no gradient: no backward, no loss
    assert not {n for n, _, _ in got} & {"lthm/backward", "lthm/loss", "lthm/attention_backward"}


def test_span_enters_no_record_function_outside_a_profiler(monkeypatch):
    entered = []
    real = spans.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(spans, "record_function", counting)
    tw = wrapper()
    encode = tw.inference_models()["user_encoder"]
    state = TrainState.create(tw)
    encode(tiny_batch())
    train_step(state, tiny_batch(), offsets=[0, 1])
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        encode(tiny_batch())
    assert entered.count("lthm/serve") == 1 and entered.count("lthm/attention") == LAYERS


@pytest.mark.cuda
def test_bias_backward_kernels_launch_inside_attention_backward(tmp_path):
    """Two bf16 MQA 32x16 layers with the bias at T = 513 under remat, on the
    card: every launch of the bias dQ and dK/dV kernels lies inside
    ``lthm/attention_backward``, and every bias forward inside
    ``lthm/attention`` (by correlation id, as ``benchmark/harness`` reads
    the trace)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cuda, t = torch.device("cuda"), 513
    stack = ttr.TransformerStack(2, 512, 32, torch.Generator(device=cuda).manual_seed(1), remat=True,
                                 attn_type="multi_query", is_causal=True, use_bias=False, pos_bias_window=t,
                                 use_flash=True, dtype=torch.bfloat16)
    x = torch.randn(8, t, 512, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2),
                    requires_grad=True)

    def step():
        stack(x, training=True).float().square().sum().backward()

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    user = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X" and e["name"].startswith("lthm/")]

    def open_at(ts):
        return {n for a, b, n in user if a <= ts <= b}

    found = Counter()
    for e in events:
        if e.get("cat") != "kernel" or e.get("ph") != "X":
            continue
        for kernel, span in (("mqa_tc_bias_dq_kernel", "lthm/attention_backward"),
                             ("mqa_tc_bias_dkv_kernel", "lthm/attention_backward"),
                             ("mqa_tc_bias_fwd_kernel", "lthm/attention")):
            if kernel in e["name"]:
                assert span in open_at(launched[e["args"]["correlation"]]), (kernel, e["ts"])
                found[kernel] += 1
    assert found["mqa_tc_bias_dq_kernel"] == 2 and found["mqa_tc_bias_dkv_kernel"] == 2, found
    assert found["mqa_tc_bias_fwd_kernel"] >= 2, found
