"""The port's batcher and loader (recommendations_tpu_torch/data/grouping.py,
generator.py, loader.py) against the JAX package's on the same rows, on the
CPU: session grouping in JAX's (pandas') order, ties on the sort column
included; snapshot resume against an uninterrupted run, also under
``process_reader``; the metadata skip against replay; the spawned
``process_reader`` against the thread reader; ``stack_step_groups`` and its
tail. Mirrors tests/test_loader_semantics.py and
tests/test_data_pipeline.py's grouping and snapshot tests."""

import copy

import numpy as np
import pandas as pd
import pytest

from recommendations_tpu.config.trainer_config import DataLoaderConfig as JaxDataLoaderConfig
from recommendations_tpu.config.trainer_config import FileSystemConfig as JaxFileSystemConfig
from recommendations_tpu.data import FakeDataStore as JaxFakeStore
from recommendations_tpu.data import GroupedBatchDataset as JaxGrouped
from recommendations_tpu.data import get_data_loader_strategy as jax_strategy
from recommendations_tpu.data import get_host_dataloader as jax_loader
from recommendations_tpu.data.loader import stack_step_groups as jax_stack
from recommendations_tpu.features import FeaturesConfig as JaxFeatures
from recommendations_tpu_torch.config.trainer_config import DataLoaderConfig, FileSystemConfig, FileSystemKind
from recommendations_tpu_torch.data.data_store import FakeDataStore
from recommendations_tpu_torch.data.generator import get_data_loader_strategy
from recommendations_tpu_torch.data.grouping import GroupedBatchDataset, group_rows, sort_order
from recommendations_tpu_torch.data.loader import HostDataLoader, get_host_dataloader, stack_step_groups
from recommendations_tpu_torch.features.feature_config import FeaturesConfig


def _keep(table):
    return table


def _identity_mapper(kind):
    """A data mapper a spawned reader can unpickle (a module-level function)."""
    return _keep


def _features(group=None):
    d = {"defaults": {}, "numerical_features": [{"name": "x", "kind": "numerical"}]}
    if group is not None:
        d["group_dataset"] = group
    return JaxFeatures(**copy.deepcopy(d)), FeaturesConfig.from_dict(copy.deepcopy(d))


def _table(df):
    return {c: df[c].to_numpy() for c in df.columns}


def _session_frames(n_chunks=10, rows_per_chunk=40, seed=0, ties=True):
    """Sessions of 1-6 rows; timestamps from a small range, so many rows of
    a session tie on the sort column."""
    rs = np.random.RandomState(seed)
    frames, uid = [], 0
    for _ in range(n_chunks):
        users, ts, xs = [], [], []
        while len(users) < rows_per_chunk:
            for i in range(rs.randint(1, 7)):
                users.append(f"u{uid}")
                ts.append(int(rs.randint(0, 3 if ties else 10_000)))
                xs.append(float(uid) + 0.01 * i)
            uid += 1
        order = rs.permutation(len(users))  # sessions interleaved in the table
        frames.append(pd.DataFrame({"user": np.asarray(users)[order], "t": np.asarray(ts)[order],
                                    "x": np.asarray(xs)[order]}))
    return frames


GROUPS = [
    {"group_by_columns": ["user"], "sort_by_columns": ["t"], "sort_reverse": False, "minimum_group_size": 2},
    {"group_by_columns": ["user"], "sort_by_columns": ["t"], "sort_reverse": True, "minimum_group_size": 1},
    {"group_by_columns": ["user"], "sort_by_columns": ["t", "x"], "sort_reverse": True, "minimum_group_size": 2,
     "maximum_group_size": 5},
    {"group_by_columns": ["t"], "sort_by_columns": ["user"], "sort_reverse": True},
    {"group_by_columns": ["user", "t"], "sort_by_columns": [], "minimum_group_size": 1},
]


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("buffer,macro", [(0, 1), (3, 2)])
def test_grouped_rows_come_out_in_jax_order(group, buffer, macro):
    """Every batch equals JAX's, bit for bit: groupby's sorted keys, the
    size filters, sort_values' order (ties on ``t`` included: numpy's
    unstable quicksort, and the reversal trick of a descending sort), and
    the shuffle buffer moving whole groups."""
    jf, tf = _features(group)
    frames = _session_frames()
    kw = dict(batch_size=4, shuffle_buffer_batches=buffer, macro_batches=macro, seed=123)
    want = [b["x"] for b in JaxGrouped(iter([f.copy() for f in frames]), jf, **kw)]
    got = [b["x"] for b in GroupedBatchDataset(iter([_table(f) for f in frames]), tf, **kw)]
    assert len(got) == len(want) > 10
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_ties_need_the_unstable_sort():
    """On a table where it matters, pandas' order (which the port follows)
    is not a stable sort's: 40 rows, three distinct keys."""
    rs = np.random.RandomState(3)
    df = pd.DataFrame({"t": rs.randint(0, 3, size=40), "x": np.arange(40.0)})
    for ascending in (True, False):
        want = df.sort_values(by=["t"], ascending=ascending)["x"].to_numpy()
        got = df["x"].to_numpy()[sort_order(_table(df), ["t"], ascending)]
        np.testing.assert_array_equal(got, want)
        stable = df.sort_values(by=["t"], ascending=ascending, kind="stable")["x"].to_numpy()
        assert not np.array_equal(want, stable) or ascending
    assert not np.array_equal(df.sort_values(by=["t"], ascending=False)["x"].to_numpy(),
                              df.sort_values(by=["t"], ascending=False, kind="stable")["x"].to_numpy())


def test_groupby_drops_missing_keys_and_sorts_them():
    df = pd.DataFrame({"k": [3.0, np.nan, 1.0, 3.0, 2.0, np.nan, 1.0], "x": np.arange(7.0)})
    want = [rows.index.to_numpy() for _, rows in df.groupby(by=["k"])]
    got = group_rows(_table(df), ["k"])
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


class _ChunkGen:
    """A generator with ``set_start_chunk``, over a fixed list of tables."""

    def __init__(self, tables):
        self._tables, self._start, self.reads = tables, 0, []

    def set_start_chunk(self, n):
        self._start = n

    def __iter__(self):
        start, self._start = self._start, 0
        for i, t in enumerate(self._tables[start:], start=start):
            self.reads.append(i)
            yield t


@pytest.mark.parametrize("buffer", [0, 3])
def test_snapshot_resume_equals_the_uninterrupted_run(buffer):
    """Restored mid-macro at batch 7 into a fresh batcher: the rest of the
    stream is the uninterrupted run's, without reading the consumed
    tables again (tests/test_data_pipeline.py:285,322)."""
    _, tf = _features(GROUPS[0])
    tables = [_table(f) for f in _session_frames()]
    kw = dict(features_config=tf, batch_size=4, shuffle_buffer_batches=buffer, macro_batches=2, seed=123)
    full = list(GroupedBatchDataset(_ChunkGen(tables), **kw))
    ds = GroupedBatchDataset(_ChunkGen(tables), **kw)
    it = iter(ds)
    consumed = 7
    for i in range(consumed):
        np.testing.assert_array_equal(next(it)["x"], full[i]["x"])
    blob = ds.snapshot(consumed)
    gen2 = _ChunkGen(tables)
    ds2 = GroupedBatchDataset(gen2, **kw)
    discard = ds2.restore_snapshot(blob)
    assert 0 <= discard < 2
    rest = list(ds2)[discard:]
    assert len(rest) == len(full) - consumed
    for a, b in zip(rest, full[consumed:]):
        np.testing.assert_array_equal(a["x"], b["x"])
    assert gen2.reads[0] > 0  # started past the consumed tables


def _fs():
    return JaxFileSystemConfig(kind="fake", path_template="tbl/date={date}"), FileSystemConfig(
        kind=FileSystemKind.FAKE, path_template="tbl/date={date}")


def _seed_many_files(n_files=6, rows=32):
    """The same files in both packages' in-memory stores."""
    JaxFakeStore.reset()
    FakeDataStore.reset()
    paths = []
    for i in range(n_files):
        df = pd.DataFrame({"x": np.arange(rows, dtype=np.float64) + 1000 * i})
        p = f"tbl/date=20240101/f{i}.parquet"
        JaxFakeStore.put_table(p, df)
        FakeDataStore.put_table(p, _table(df))
        paths.append(p)
    return paths


def _loaders(dl, skip=0, snapshot=None, jax_too=True):
    jfs, tfs = _fs()
    jf, tf = _features()
    paths = _seed_many_files()
    port = get_host_dataloader("train", 0, list(paths), 8, None,
                               get_data_loader_strategy(DataLoaderConfig(**dl), ["x"], _identity_mapper),
                               tf, tfs, skip_batches=skip, snapshot=snapshot)
    if not jax_too:
        return port, None
    jl = jax_loader("train", 0, list(paths), 8, None,
                    jax_strategy(JaxDataLoaderConfig(**dl), ["x"], lambda kind: (lambda df: df)),
                    jf, jfs, skip_batches=skip)
    return port, jl


def test_metadata_skip_equals_replay_and_jax():
    """skip_batches=7 with shuffled files, per-chunk shuffles and two
    readers: the generator skips whole chunks by the store's row counts
    and lands on the batch that replay (and JAX's loader) reach."""
    dl = dict(block_size=2, shuffle_files=True, shuffle_data=True, max_readers=2)
    full, jfull = _loaders(dl)
    full, jfull = [b["x"] for b in full], [b["x"] for b in jfull]
    assert len(full) == len(jfull) >= 10
    for a, b in zip(full, jfull):
        np.testing.assert_array_equal(a, b)
    skipped, jskipped = _loaders(dl, skip=7)
    assert skipped.skip_applied and jskipped.skip_applied
    rest = [b["x"] for b in skipped]
    assert len(rest) == len(full) - 7
    for a, b, c in zip(rest, full[7:], [b["x"] for b in jskipped]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_metadata_skip_refused_with_a_shuffle_buffer_or_grouping():
    loader, _ = _loaders(dict(block_size=2, shuffle_files=False, shuffle_buffer_num_mini_batches=2), skip=3,
                         jax_too=False)
    assert not loader.skip_applied
    _, tf = _features(GROUPS[0])
    ds = GroupedBatchDataset(iter([]), tf, batch_size=4)
    assert not ds.request_skip(3)


def _grouped_store(n_files=4):
    """Session tables in both stores; the features group them."""
    JaxFakeStore.reset()
    FakeDataStore.reset()
    paths = []
    for i, df in enumerate(_session_frames(n_chunks=n_files, rows_per_chunk=48, seed=5)):
        p = f"tbl/date=20240101/s{i}.parquet"
        JaxFakeStore.put_table(p, df)
        FakeDataStore.put_table(p, _table(df))
        paths.append(p)
    return paths


@pytest.mark.parametrize("process_reader", [False, True])
def test_loader_snapshot_resume_equals_the_uninterrupted_run(process_reader):
    """Through get_host_dataloader with grouping, a shuffle buffer and macro
    batches: the snapshot taken after 5 consumed batches (asked of the child
    process under process_reader) restores, after its alignment batches, to
    the uninterrupted run's stream; the thread reader's and the process
    reader's streams equal JAX's loader's."""
    paths = _grouped_store()
    _, tfs = _fs()
    jfs, _ = _fs()
    jf, tf = _features(GROUPS[1])
    dl = dict(block_size=1, shuffle_files=True, shuffle_buffer_num_mini_batches=2, macro_batches_multiples=2,
              process_reader=process_reader)
    strategy = get_data_loader_strategy(DataLoaderConfig(**dl), ["user", "t", "x"], _identity_mapper)

    def build(snapshot=None):
        return get_host_dataloader("train", 0, list(paths), 4, None, strategy, tf, tfs, snapshot=snapshot)

    jdl = {k: v for k, v in dl.items() if k != "process_reader"}
    want = [b["x"] for b in jax_loader("train", 0, list(paths), 4, None,
                                       jax_strategy(JaxDataLoaderConfig(**jdl), ["user", "t", "x"],
                                                    lambda kind: (lambda df: df)), jf, jfs)]
    loader = build()
    it = iter(loader)
    head = [next(it)["x"] for _ in range(5)]
    blob = loader.snapshot(5)
    tail = [b["x"] for b in it]
    # asked again after the last batch (a prefetching consumer is there
    # before its checkpoint): the child is still up to answer
    assert loader.snapshot(5) == blob
    loader.close()
    full = head + tail
    assert len(full) == len(want) > 8
    for a, b in zip(full, want):
        np.testing.assert_array_equal(a, b)
    resumed = build(snapshot=blob)
    assert resumed.skip_applied and resumed.discard_batches == 1
    rest = [b["x"] for b in resumed][resumed.discard_batches:]
    assert len(rest) == len(full) - 5
    for a, b in zip(rest, full[5:]):
        np.testing.assert_array_equal(a, b)


def _failing_tables():
    yield {"x": np.array([1.0])}
    raise RuntimeError("boom in the reader")


class _FailingDataset(GroupedBatchDataset):
    def __init__(self):
        super().__init__(iter([]), _features()[1], batch_size=1)

    def __iter__(self):
        yield from GroupedBatchDataset(_failing_tables(), _features()[1], batch_size=1)


@pytest.mark.parametrize("process_reader", [False, True])
def test_reader_failures_reach_the_consumer(process_reader):
    with pytest.raises(RuntimeError, match="boom in the reader"):
        list(HostDataLoader(_FailingDataset(), process_reader=process_reader))


def test_process_reader_matches_thread_mode():
    """The spawned child yields the thread reader's batches, bit for bit, in
    order (the in-memory store's tables travel with the recipe: the child
    does not share the parent's memory)."""
    dl = dict(block_size=2, shuffle_files=True, shuffle_data=True)
    thread, _ = _loaders(dl, jax_too=False)
    proc, _ = _loaders(dict(dl, process_reader=True), jax_too=False)
    a, b = list(thread), list(proc)
    proc.close()
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_stack_step_groups_and_its_tail():
    batches = [{"x": np.full((4,), i), "s": np.array(["a"] * 4, dtype=object)} for i in range(5)]
    got = list(stack_step_groups(iter(batches), 2))
    want = list(jax_stack(iter(copy.deepcopy(batches)), 2))
    assert [t for t, _ in got] == [t for t, _ in want] == ["multi", "multi", "single"]
    for (_, a), (_, b) in zip(got, want):
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(a["x"], b["x"])
    assert got[0][1]["x"].shape == (2, 4) and "s" not in got[0][1]
    np.testing.assert_array_equal(got[2][1]["x"], np.full((4,), 4))
