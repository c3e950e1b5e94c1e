"""The training step replayed as a CUDA graph (``train/step_graph.py``) on
the card: graphed steps give the eager steps' bits (losses, parameters,
AdamW's moments, the logQ state; the eager run's AdamW made capturable
where the graphed run's capture makes it), also across a
``load_state_dict``; the
returned losses are the caller's own; a replay makes no synchronizing call;
the LFM2 stack's step captures too.

These tests need an NVIDIA GPU and skip without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_step_graph_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""

import copy

import numpy as np
import pytest
import torch

from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
from recommendations_tpu_torch.core import spans
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.ops.cuda_build import ALL_KERNELS
from recommendations_tpu_torch.train import step_graph
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState

pytestmark = pytest.mark.cuda

STEPS = 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def small_config(fused_ce: bool, backbone=None):
    """2 bf16 layers, d=128, MQA with 8 heads of 16, context 64, three
    lookahead heads, CE chunks of 4 users."""
    cfg = dict(
        features={"defaults": {}},
        compute_dtype="bfloat16",
        transformer_config=dict(
            rotator_config={"ff_mult": 4}, is_causal=True, num_layers=2, use_flash_attention=True,
            enable_gradient_checkpointing=True,
            attn_config=dict(n_head=8, n_embd=128, attn_type="multi_query", dropout=0.0, attn_dropout=0.0,
                             bias=False),
        ),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=128, product_emb_dim=32, norm_bins=8,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 16}],
            latent_model_config={"vocab_size_latent": 100_000, "num_shifts_latent": 4, "normalize_embedding": True},
        ),
        log_q_config={"num_buckets": 4096, "hash_offsets": [0, 7, 34144]},
        lookahead=[0, 2, 5],
        context_width=64,
        table_optimizer="auto",
        train_mini_batch_size=4,
        fused_ce=fused_ce,
        lr=1e-3,
    )
    if backbone is not None:
        cfg["transformer_config"] = backbone
    return cfg


# LFM2-8B-A1B's block as the backbone (nn/lfm2.py), small: a conv layer with
# the dense SwiGLU, then an attention and a conv layer with routed experts
LFM2_BACKBONE = dict(backbone="lfm2_moe", hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
                     intermediate_size=256, moe_intermediate_size=64, num_experts=8, num_experts_per_tok=2,
                     num_dense_layers=1, layer_types=["conv", "full_attention", "conv"],
                     enable_gradient_checkpointing=True)


def batches(device, n=STEPS, b=8, s=80):
    rs = np.random.RandomState(11)
    out = []
    for _ in range(n):
        ids = rs.randint(1, 5000, size=(b, s)).astype(np.int64)  # repeated ids: colliding logQ buckets
        ids[:, :rs.randint(0, s // 2)] = 0
        out.append({
            "product_ids": torch.from_numpy(ids).to(device),
            "labels": torch.from_numpy(rs.randint(0, 4, size=(b, s)).astype(np.float32)).to(device),
            "timestamps": torch.from_numpy(
                rs.randint(1_600_000_000, 1_700_000_000, size=(b, s)).astype(np.float32)).to(device),
        })
    return out


def make_state(cfg, device):
    wrapper = LTHMModelWrapper(LTHMModelConfig.from_dict(cfg), device=device, seed=1)
    return TrainState.create(wrapper, ModelTrainConfig(gradient_clip_norm=1.0), seed=3)


def snapshot(state):
    """Every number the steps change: parameters, AdamW's state, the aux state."""
    out = {f"param/{n}": p.detach().clone() for n, p in state.wrapper.module.named_parameters()}
    for i, opt in enumerate(state.optimizer.optimizers()):
        for j, p in enumerate(opt.param_groups[0]["params"]):
            for k, v in opt.state.get(p, {}).items():
                out[f"opt{i}/{j}/{k}"] = v.detach().clone()
    aux = state.aux
    out.update({"logq/b": aux.logq.b.clone(), "logq/a": aux.logq.a.clone(), "batch_idx": aux.batch_idx.clone()})
    return out


def run(state, feed, eager=False, monkeypatch=None):
    """The steps of ``feed``; ``eager``: all of them eager, AdamW made
    capturable after the first, as a graphed run's capture makes it."""
    if eager:
        monkeypatch.setattr(step_graph, "eager_reason", lambda *a, **k: "held eager")
        losses = [train_step(state, feed[0])]
        step_graph.make_capturable(state.optimizer)
        losses += [train_step(state, batch) for batch in feed[1:]]
        monkeypatch.undo()
    else:
        losses = [train_step(state, batch) for batch in feed]
    torch.cuda.synchronize()
    return [(loss.clone(), {k: v.clone() for k, v in m.items()}) for loss, m in losses]


def assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def tallies():
    return {k.rsplit("/", 1)[1]: int(v) for k, v in spans.counters().items() if k.startswith("lthm/step_graph/")}


def launches():
    return {kern.name: kern.launches for kern in ALL_KERNELS}


@pytest.mark.parametrize("fused_ce", [False, True])
def test_graphed_steps_equal_eager_steps_bit_for_bit(cuda, fused_ce, monkeypatch):
    """Also the kernels' launch counts: a replay adds what its capture
    counted."""
    feed = batches(cuda)
    eager_state = make_state(small_config(fused_ce), cuda)
    before = launches()
    eager = run(eager_state, feed, eager=True, monkeypatch=monkeypatch)
    eager_launches = {k: n - before[k] for k, n in launches().items()}
    spans.reset_counters()
    graph_state = make_state(small_config(fused_ce), cuda)
    before = launches()
    graphed = run(graph_state, feed)
    assert {k: n - before[k] for k, n in launches().items()} == eager_launches
    assert sum(eager_launches.values()) >= 4 * STEPS  # the CE kernels, at least
    assert tallies() == {"eager": 1, "replays": STEPS - 1}
    for (le, me), (lg, mg) in zip(eager, graphed):
        assert torch.equal(le, lg)
        assert_same_bits(me, mg)
    assert_same_bits(snapshot(eager_state), snapshot(graph_state))
    assert graph_state.step == eager_state.step == STEPS


def test_graphed_steps_hold_across_load_state_dict(cuda, monkeypatch):
    """Three graphed steps, the state saved, three more; the saved state
    loaded back (the graph dropped, warmed up and captured again) gives the
    last three steps' bits, as eager steps from it do."""
    feed = batches(cuda)
    state = make_state(small_config(True), cuda)
    run(state, feed[:3])
    saved = copy.deepcopy(state.state_dict())
    after = run(state, feed[3:])
    want = snapshot(state)
    state.load_state_dict(copy.deepcopy(saved))
    assert state.graph is None
    again = run(state, feed[3:])
    assert state.graph is not None and state.graph.graph is not None
    assert_same_bits(snapshot(state), want)
    for (la, _), (lb, _) in zip(after, again):
        assert torch.equal(la, lb)
    eager_state = make_state(small_config(True), cuda)
    eager_state.load_state_dict(copy.deepcopy(saved))
    run(eager_state, feed[3:], eager=True, monkeypatch=monkeypatch)
    assert_same_bits(snapshot(eager_state), want)


def test_returned_losses_are_the_callers_own(cuda):
    feed = batches(cuda)
    state = make_state(small_config(True), cuda)
    out = [train_step(state, batch) for batch in feed]
    torch.cuda.synchronize()
    values = [loss.item() for loss, _ in out]
    ptrs = {loss.data_ptr() for loss, _ in out}
    assert len(ptrs) == len(out)
    graph_buffers = {t.data_ptr() for t in state.graph.packed.values()}
    assert not ptrs & graph_buffers
    for batch in feed:  # more replays leave the returned losses as they were
        train_step(state, batch)
    torch.cuda.synchronize()
    assert [loss.item() for loss, _ in out] == values


def test_replay_makes_no_synchronizing_call(cuda):
    """After the warm-up and the capture, replays under the sync debug
    mode "error": only the bounded wait on a step's event waits, which
    the mode does not count."""
    feed = batches(cuda)
    state = make_state(small_config(True), cuda)
    for batch in feed[:2]:
        train_step(state, batch)
    spans.reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in feed:
            train_step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tallies() == {"replays": STEPS}


def test_lfm2_step_captures(cuda, monkeypatch):
    """The LFM2 stack's routed MoE (top-k, sort, grouped products with
    device offsets) reads no device value on the host: its step captures,
    and its replays follow the eager steps (a scatter's float adds in another
    order can move the last bits)."""
    feed = batches(cuda)
    cfg = small_config(True, backbone=dict(LFM2_BACKBONE))
    spans.reset_counters()
    state = make_state(cfg, cuda)
    graphed = run(state, feed)
    got = tallies()
    print("LFM2 step:", "captured" if got.get("replays") else "kept eager", got)
    assert got == {"eager": 1, "replays": STEPS - 1}
    eager = run(make_state(cfg, cuda), feed, eager=True, monkeypatch=monkeypatch)
    for (le, _), (lg, _) in zip(eager, graphed):
        torch.testing.assert_close(lg, le, rtol=1e-3, atol=1e-3)


def test_a_step_that_synchronizes_stays_eager(cuda):
    """A loss that reads a device value on the host: the warm-up sees the
    synchronizing call, so no capture is tried and every step runs eager;
    the default CUDA generator still draws afterwards."""
    feed = batches(cuda)
    state = make_state(small_config(True), cuda)
    loss_and_metrics = state.wrapper.loss_and_metrics

    def reads_on_host(*args, **kwargs):
        loss, metrics, aux = loss_and_metrics(*args, **kwargs)
        metrics["host_loss"] = torch.full((), loss.item(), device=loss.device)
        return loss, metrics, aux

    state.wrapper.loss_and_metrics = reads_on_host
    spans.reset_counters()
    out = run(state, feed)
    assert tallies() == {"eager": STEPS}
    assert state.graph.failed and state.graph.graph is None
    assert all(torch.isfinite(loss) for loss, _ in out)
    assert torch.randn(4, device=cuda).isfinite().all()


def test_an_eager_step_between_replays_keeps_the_bits(cuda, monkeypatch):
    """A step under a profiler runs eager beside the held graph (its own
    gradients and aux state); the next replay takes the graph's gradients
    back and copies the eager aux state in: the same bits as eager steps."""
    from torch.profiler import ProfilerActivity, profile

    feed = batches(cuda)
    state = make_state(small_config(True), cuda)
    spans.reset_counters()
    out = run(state, feed[:3])
    with profile(activities=[ProfilerActivity.CPU]):
        out += run(state, feed[3:4])
    assert state.graph is not None and state.graph.graph is not None
    out += run(state, feed[4:])
    assert tallies() == {"eager": 2, "replays": STEPS - 2}
    eager_state = make_state(small_config(True), cuda)
    eager = run(eager_state, feed, eager=True, monkeypatch=monkeypatch)
    for (le, _), (lg, _) in zip(eager, out):
        assert torch.equal(le, lg)
    assert_same_bits(snapshot(eager_state), snapshot(state))
