"""When the training step replays a CUDA graph (``train/step_graph.py``):
the engage rule's cases on the CPU, each of which runs the step eager and
tallies it under ``lthm/step_graph/eager``, and the warm-up that precedes
a capture. The graph itself is tested on the card
(``tests/test_torch_step_graph_cuda.py``).

The rule is asked of a state whose wrapper says it is on a card (only the
rule reads that); the steps run on the CPU.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
from recommendations_tpu_torch.core import spans
from recommendations_tpu_torch.models.lthm.config import LTHMModelConfig
from recommendations_tpu_torch.models.lthm.wrapper import LTHMModelWrapper
from recommendations_tpu_torch.train import step_graph
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState

torch.set_num_threads(2)


def tiny_config():
    """2 layers, d=32, MQA with 4 heads, context 12, two lookahead heads."""
    return dict(
        features={"defaults": {}},
        compute_dtype="float32",
        transformer_config=dict(
            rotator_config={"ff_mult": 2}, is_causal=True, num_layers=2, use_flash_attention=True,
            enable_gradient_checkpointing=True,
            attn_config=dict(n_head=4, n_embd=32, attn_type="multi_query", dropout=0.0, attn_dropout=0.0,
                             bias=False),
        ),
        product_tower=dict(
            inp_emb_dim=16, out_emb_dim=32, product_emb_dim=16, norm_bins=8, detach_item_tower=False,
            cosine_lsh_config=[{"num_bins": 4, "num_proj": 8}],
            latent_model_config={"vocab_size_latent": 3000, "num_shifts_latent": 2, "normalize_embedding": True},
        ),
        log_q_config={"num_buckets": 64, "hash_offsets": [0, 7]},
        lookahead=[0, 2],
        context_width=12,
        table_optimizer="frozen",
        lr=1e-3,
    )


def tiny_batch(b=3, s=16):
    rs = np.random.RandomState(b * 100 + s)
    ids = rs.randint(1, 2**62, size=(b, s)).astype(np.int64)
    ids[:, -3:] = 0
    return {
        "product_ids": torch.from_numpy(ids),
        "labels": torch.from_numpy(rs.randint(0, 4, size=(b, s)).astype(np.float32)),
        "timestamps": torch.from_numpy(rs.randint(1_600_000_000, 1_700_000_000, size=(b, s)).astype(np.float32)),
    }


def make_state(train=None, attn_dropout=0.0, table_optimizer="frozen"):
    cfg = tiny_config()
    cfg["transformer_config"]["attn_config"]["attn_dropout"] = attn_dropout
    cfg["table_optimizer"] = table_optimizer
    wrapper = LTHMModelWrapper(LTHMModelConfig.from_dict(cfg), device="cpu", seed=1)
    return TrainState.create(wrapper, train or ModelTrainConfig())


def as_if_on_card(state):
    """The same state, its wrapper saying it is on a card."""
    shown = copy.copy(state)
    shown.wrapper = copy.copy(state.wrapper)
    shown.wrapper.device = torch.device("cuda")
    return shown


def _cpu(state):
    return state


def _mesh(state):
    state.wrapper.mesh = object()
    return state


def _new_shape(state):
    state.graph = step_graph.StepGraph(step_graph.signature(tiny_batch(b=2), [0, 1]))
    return state


def _schedule(state):
    state.optimizer = copy.copy(state.optimizer)
    state.optimizer.scheduler = object()
    return state


CASES = {
    "cpu": (dict(), _cpu, step_graph.NOT_CUDA, False),
    "mesh": (dict(), _mesh, step_graph.MESH, True),
    "dropout": (dict(attn_dropout=0.1), _cpu, step_graph.DROPOUT, True),
    "lazy_table": (dict(table_optimizer="lazy_rowwise_adam"), _cpu, step_graph.ROW_SPARSE_TABLE, True),
    "fused_table": (dict(table_optimizer="sparse_fused_adam"), _cpu, step_graph.ROW_SPARSE_TABLE, True),
    "accumulation": (dict(train=ModelTrainConfig(gradient_accumulation_steps=2)), _cpu, step_graph.ACCUMULATION,
                     True),
    "schedule": (dict(), _schedule, step_graph.SCHEDULE, True),
    "new_shape": (dict(), _new_shape, step_graph.NEW_SHAPE, True),
}


@pytest.mark.parametrize("case", [*CASES, "profiler"])
def test_engage_rule_keeps_the_step_eager_and_tallies_it(case):
    """Each case the rule names runs the step eager, tallied under
    ``lthm/step_graph/eager``."""
    kw, change, want, on_card = CASES.get(case, (dict(), _cpu, step_graph.PROFILER, True))
    state = make_state(**kw)
    batch = tiny_batch()
    asked = as_if_on_card(state) if on_card else state
    if case == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            assert step_graph.eager_reason(asked, batch, [0, 1]) == want
    else:
        assert step_graph.eager_reason(change(asked), batch, [0, 1]) == want
    spans.reset_counters()
    if case == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            loss, _ = train_step(state, batch, offsets=[0, 1])
    else:
        loss, _ = train_step(state, batch, offsets=[0, 1])
    assert torch.isfinite(loss)
    assert {k: int(v) for k, v in spans.counters().items() if k.startswith("lthm/step_graph/")} == {
        "lthm/step_graph/eager": 1}
    assert state.graph is None and state.step == 1
    spans.reset_counters()


def test_on_the_card_the_rule_asks_only_for_the_batch_there():
    """Without any case above, the rule's one objection on the CPU is the
    batch's device."""
    state = as_if_on_card(make_state())
    assert step_graph.eager_reason(state, tiny_batch(), [0, 1]) == step_graph.BATCH_OFF_CARD


@pytest.mark.parametrize("synchronizes", [False, True])
def test_an_eligible_step_warms_up_and_a_new_shape_warms_up_again(monkeypatch, synchronizes):
    """The first step the rule lets through runs eager, watched for
    synchronizing calls, and notes the batch's shapes for the capture; a
    batch of other shapes before any capture runs eager and notes its own.
    A warm-up that synchronized leaves the state eager. Nothing is captured
    on the CPU."""
    state = make_state()
    a, b = tiny_batch(), tiny_batch(b=2)

    def rule(st, batch, offsets=None):
        held = st.graph
        if held is not None and held.failed:
            return step_graph.NO_CAPTURE
        if held is not None and held.signature != step_graph.signature(batch, offsets):
            return step_graph.NEW_SHAPE
        return None

    @contextlib.contextmanager
    def watch():
        found = []
        yield found
        if synchronizes:
            found.append(step_graph.SYNC_WARNING)

    def body(st, batch, offsets, seed):
        return torch.zeros(()), {}, st.aux

    monkeypatch.setattr(step_graph, "eager_reason", rule)
    monkeypatch.setattr(step_graph, "_synchronizing_calls", watch)
    spans.reset_counters()
    step_graph.run(state, a, torch.tensor([0, 1]), 0, body)
    assert state.graph.signature == step_graph.signature(a, [0, 1]) and state.graph.graph is None
    assert state.graph.failed == synchronizes
    first = state.graph
    step_graph.run(state, b, torch.tensor([0, 1]), 0, body)
    if synchronizes:
        assert state.graph is first
    else:
        assert state.graph is not first and state.graph.signature == step_graph.signature(b, [0, 1])
    assert int(spans.counters()["lthm/step_graph/eager"]) == 2
    spans.reset_counters()
    state.load_state_dict(state.state_dict())
    assert state.graph is None
