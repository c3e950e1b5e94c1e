"""The port's asynchronous checkpoints (``train/checkpoint.py``), as Orbax's
``enable_async_checkpointing`` in the JAX package: ``save`` returns before
the file exists (its writer held by an event) and ``wait`` completes it; a
second ``save`` waits for the first; the file is the synchronous
``torch.save``'s bytes (tensors sharing a storage still share it); an
error in the writer surfaces at the next ``wait`` (once) or ``save``; and
the training strategy waits where the JAX strategy waits: before the NaN
stop, and ``wait`` then ``close`` at the end of training. The resume tests
of ``test_torch_trainer.py``, ``test_torch_ranker.py`` and
``test_torch_data_parallel.py`` end on the same bits through it."""

import collections
import os
import sys
import threading

import numpy as np
import pytest
import torch

from recommendations_tpu_torch import main_training
from recommendations_tpu_torch.data.data_store import FakeDataStore
from recommendations_tpu_torch.tools import synth_data as tsynth
from recommendations_tpu_torch.train import checkpoint as ckpt
from recommendations_tpu_torch.train import strategy as strategy_mod

Pair = collections.namedtuple("Pair", "first second")


class _State:
    def __init__(self, sd):
        self.sd = sd

    def state_dict(self):
        return self.sd

    def load_state_dict(self, sd):
        self.sd = sd


def _state(seed=0):
    base = torch.from_numpy(np.random.RandomState(seed).randn(24).astype(np.float32))
    return {"module": torch.nn.Linear(4, 3).state_dict(), "views": [base, base[3:9], base.view(4, 6)],
            "aux": Pair(torch.arange(5), 2), "step": 7, "generator": torch.Generator().manual_seed(seed).get_state()}


@pytest.fixture
def held_writes(monkeypatch):
    """``torch.save`` in the writer blocks until the event is set."""
    release, entered = threading.Event(), threading.Event()
    original = torch.save

    def held(obj, f, *a, **kw):
        entered.set()
        assert release.wait(30)
        return original(obj, f, *a, **kw)

    monkeypatch.setattr(ckpt.torch, "save", held)
    return release, entered


def test_save_returns_before_the_file_exists_and_wait_completes_it(tmp_path, held_writes):
    release, entered = held_writes
    mgr = ckpt.CheckpointManager(str(tmp_path))
    sd = _state()
    mgr.save(3, _State(sd), {"loss": 0.5}, {"epoch": 0, "batches_in_epoch": 3})
    assert entered.wait(30)
    assert mgr.steps() == [] and not os.path.exists(mgr.path(3))
    sd["views"][0].add_(1.0)  # the copy was taken at save: a later step does not reach the file
    release.set()
    mgr.wait()
    assert mgr.steps() == [3]
    state = _State(None)
    _, data_iter = mgr.restore(state)
    assert data_iter == {"epoch": 0, "batches_in_epoch": 3}
    np.testing.assert_array_equal(state.sd["views"][0].numpy(), _state()["views"][0].numpy())
    v = state.sd["views"]
    assert v[1].untyped_storage().data_ptr() == v[0].untyped_storage().data_ptr()  # one storage, as saved
    assert type(state.sd["aux"]) is Pair and state.sd["step"] == 7


def test_a_second_save_waits_for_the_first_and_the_oldest_go(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, _State(_state(step)))
    mgr.close()
    assert mgr.steps() == [2, 3]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_the_file_is_the_synchronous_saves_bytes(tmp_path):
    """The same file name in two directories: one by the manager, one by
    ``torch.save`` of the same payload, as the synchronous manager wrote."""
    sd = _state(4)
    mgr = ckpt.CheckpointManager(str(tmp_path / "async"))
    mgr.save(5, _State(sd), {"loss": 1.25}, {"epoch": 1})
    mgr.wait()
    sync = tmp_path / "sync"
    sync.mkdir()
    tmp = os.path.join(sync, "step_00000005.pt") + f".{os.getpid()}.tmp"
    torch.save({"state": sd, "metrics": {"loss": 1.25}, "data_iter": {"epoch": 1}}, tmp)
    os.replace(tmp, sync / "step_00000005.pt")
    assert (sync / "step_00000005.pt").read_bytes() == open(mgr.path(5), "rb").read()


def test_a_writer_error_surfaces_at_wait_and_at_save(tmp_path, monkeypatch):
    def failing(*a, **kw):
        raise OSError("disk full")

    mgr = ckpt.CheckpointManager(str(tmp_path))
    monkeypatch.setattr(ckpt.torch, "save", failing)
    mgr.save(1, _State(_state()))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once
    mgr.save(2, _State(_state()))
    with pytest.raises(OSError, match="disk full"):
        mgr.save(3, _State(_state()))
    monkeypatch.undo()
    mgr.save(4, _State(_state()))
    mgr.close()
    assert mgr.steps() == [4]


def _ranker_run(tmp, tag, steps=6):
    argv = ["--config-name", "ranker_train", "--device", "cpu", "dataset.filesystem_config.kind=fake",
            f"train.train_steps={steps}", "train.validation_steps=0", "train.train_metrics_every_n_steps=3",
            "train.checkpoint_every_k_steps=3", f"checkpoint_dir={tmp}/ckpt_{tag}", "inference.skip_inference=true",
            f"export.filesystem_config.local_dir_prefix={tmp}/export_{tag}",
            f"trackers.trackers=[{{kind: jsonl, path: {tmp}/{tag}.jsonl}}]", f"model_version={tag}", "run_id=r1"]
    return main_training.main(argv, return_pipeline=True)


@pytest.fixture
def ranker_data():
    FakeDataStore.reset()
    tsynth.write_ranking_dataset(None, ["20240101", "20240102"], files_per_date=1, rows_per_file=2048,
                                 fake_store=True)
    yield
    FakeDataStore.reset()


@pytest.fixture
def manager_calls(monkeypatch):
    """The strategy's own calls of ``save`` (with its step), ``wait`` and
    ``close`` (not the manager's calls of its own methods)."""
    calls = []
    for name in ("save", "wait", "close"):
        original = getattr(ckpt.CheckpointManager, name)

        def recorded(self, *a, _name=name, _original=original, **kw):
            if sys._getframe(1).f_globals["__name__"] == strategy_mod.__name__:
                calls.append(_name if _name != "save" else ("save", a[0]))
            return _original(self, *a, **kw)

        monkeypatch.setattr(ckpt.CheckpointManager, name, recorded)
    return calls


def test_the_strategy_waits_and_closes_at_the_end(tmp_path, ranker_data, manager_calls):
    """The ranker's trainer, a checkpoint every 3 of 6 steps: the last
    checkpoint is on disk when training returns."""
    pipeline, _ = _ranker_run(str(tmp_path), "a")
    assert manager_calls == [("save", 3), ("save", 6), "wait", "close"]
    assert sorted(n for n in os.listdir(tmp_path / "ckpt_a") if ".pt" in n) == ["step_00000003.pt",
                                                                                 "step_00000006.pt"]
    assert pipeline._trained[1].step == 6


def test_the_strategy_waits_before_the_nan_stop(tmp_path, ranker_data, manager_calls, monkeypatch):
    """NaN at step 6 (the watchdog's metric forced): the step-3 checkpoint
    is on disk, waited for before the raise, as JAX's strategy waits."""
    original = strategy_mod._host_metrics

    def nan_at_six(metrics):
        out = original(metrics)
        if manager_calls:  # after the step-3 checkpoint
            out["params_nan"] = 1.0
        return out

    monkeypatch.setattr(strategy_mod, "_host_metrics", nan_at_six)
    with pytest.raises(ValueError, match="NaN in loss or parameters at step 6"):
        _ranker_run(str(tmp_path), "b")
    assert manager_calls == [("save", 3), "wait"]
    assert [n for n in os.listdir(tmp_path / "ckpt_b") if ".pt" in n] == ["step_00000003.pt"]
