"""Session grouping and fixed-shape batches from a stream of tables.

Port of ``recommendations_tpu/data/grouping.py`` (reference
``commons/data/torch_data_loader.py:15-141``): ``make_features_compliant``
turns a batch's columns into dense arrays per feature kind, and
``GroupedBatchDataset`` cuts the stream of tables into batches of exactly
``batch_size`` rows (the last partial batch dropped, or padded and masked),
with the session grouping (``group_dataset``), the shuffle buffer (which
moves whole groups when grouping), the macro batches and the resume
snapshots of the JAX package.

The JAX package groups and sorts with pandas; the port's tables are numpy
columns, so pandas' order is made by hand (``group_rows``, ``sort_order``):
``groupby`` walks its keys in sorted order, drops rows whose key is
missing, and keeps each group's rows in their order in the table; a
``sort_values`` on one numeric column is pandas' ``nargsort``: numpy's
(unstable) quicksort, and for a descending sort the same quicksort of the
reversed column, reversed, so rows with equal keys come out in pandas'
order, which a stable sort does not give. On several columns it is pandas'
``lexsort_indexer`` (stable), and on one string column pandas' Arrow-backed
string sort (stable), missing values last in both.
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from recommendations_tpu_torch.features.feature_config import FeaturesConfig, GroupDatasetConfig
from recommendations_tpu_torch.features.transforms import Table, concat_tables, is_missing, num_rows, take_rows

Batch = Dict[str, np.ndarray]


def _coerce_to_shape(value: List[np.ndarray], shape) -> np.ndarray:
    """A ragged list of per-step vectors stacked to ``shape``, zero-padded -
    reference ``torch_data_loader.py:15-26``."""
    sentinel = np.zeros(shape[1:])
    vals = [np.asarray(v) for v in value]
    if shape[0] > len(vals):
        vals = vals + (shape[0] - len(vals)) * [sentinel]
    return np.stack(vals[: shape[0]], axis=0)


def make_features_compliant(columns: Dict[str, Any], features_config: FeaturesConfig) -> Batch:
    """A batch's columns -> dense arrays per feature kind - reference
    ``torch_data_loader.py:29-75``."""
    out: Batch = {}
    for key, values in columns.items():
        tf = features_config.get_tensor_feature(key)
        if tf is not None:
            rows = []
            for v in values:
                v = np.asarray(v)
                if v.shape != tf.get_emb_dim_as_shape():
                    v = _coerce_to_shape(list(v), tf.get_emb_dim_as_shape())
                rows.append(v)
            out[key] = np.stack(rows, axis=0).astype(np.float32)
            continue

        tlf = features_config.get_tensor_list_feature(key)
        if tlf is not None:
            rows = []
            for v in values:
                v = np.asarray(v, dtype=np.float32)
                if v.shape != tuple(tlf.get_shape()):
                    raise ValueError(f"{key} shape {v.shape} != declared {tlf.get_shape()}")
                rows.append(v)
            out[key] = np.stack(rows, axis=0)
            continue

        if features_config.get_one_hot_string_feature(key) is not None or (
            features_config.get_categorical_history_feature(key) is not None
        ):
            out[key] = np.stack([np.asarray(v, dtype=np.int64) for v in values], axis=0)
            continue

        if features_config.is_do_not_convert_to_platform_type(key):
            out[key] = np.asarray(values, dtype=object)
            continue

        arr = np.asarray(values)
        if arr.dtype == object:
            try:
                arr = np.stack([np.asarray(v) for v in values], axis=0)
            except Exception:
                out[key] = np.asarray(values, dtype=object)
                continue
        out[key] = arr
    return out


def _missing(column: np.ndarray) -> np.ndarray:
    """pandas' ``isna`` of a column."""
    if column.dtype == object:
        return np.fromiter((is_missing(v) for v in column), dtype=bool, count=len(column))
    if column.dtype.kind in "fc":
        return np.isnan(column)
    return np.zeros(len(column), dtype=bool)


def _codes(column: np.ndarray) -> np.ndarray:
    """Each value's rank among the column's sorted distinct values."""
    return np.unique(column, return_inverse=True)[1].reshape(-1)


def group_rows(table: Table, columns: List[str]) -> List[np.ndarray]:
    """``table.groupby(by=columns)``: the row indices of each group, groups
    in sorted key order, rows in table order; rows with a missing key are
    dropped."""
    n = num_rows(table)
    valid = np.ones(n, dtype=bool)
    for c in columns:
        valid &= ~_missing(np.asarray(table[c]))
    rows = np.nonzero(valid)[0]
    if not len(rows):
        return []
    codes = [_codes(np.asarray(table[c])[rows]) for c in columns]
    order = np.lexsort(codes[::-1])  # stable: the first column is the primary key
    stacked = np.stack([c[order] for c in codes], axis=1)
    starts = np.concatenate([[0], np.nonzero((stacked[1:] != stacked[:-1]).any(axis=1))[0] + 1, [len(order)]])
    return [rows[order[a:b]] for a, b in zip(starts[:-1], starts[1:])]


def sort_order(table: Table, columns: List[str], ascending: bool) -> np.ndarray:
    """``table.sort_values(by=columns, ascending=ascending)``'s row order
    (missing values last)."""
    keys = [np.asarray(table[c]) for c in columns]
    n = num_rows(table)
    if len(keys) == 1 and keys[0].dtype != object:
        k = keys[0]
        mask = _missing(k)
        idx = np.arange(n)
        non_nans, non_nan_idx = k[~mask], idx[~mask]
        if not ascending:
            non_nans, non_nan_idx = non_nans[::-1], non_nan_idx[::-1]
        indexer = non_nan_idx[non_nans.argsort(kind="quicksort")]
        if not ascending:
            indexer = indexer[::-1]
        return np.concatenate([indexer, np.nonzero(mask)[0]])
    if len(keys) == 1:
        k = keys[0]
        mask = _missing(k)
        live = [i for i in range(n) if not mask[i]]
        live.sort(key=lambda i: k[i], reverse=not ascending)  # stable both ways
        return np.concatenate([np.asarray(live, dtype=np.int64), np.nonzero(mask)[0]])
    labels = []
    for k in reversed(keys):
        mask = _missing(k)
        codes = np.full(n, -1, dtype=np.int64)
        codes[~mask] = _codes(k[~mask])
        m = int(codes.max()) + 1 if (~mask).any() else 0
        codes = np.where(mask, m, codes)
        if not ascending:
            codes = np.where(mask, codes, m - codes - 1)
        labels.append(codes)
    return np.lexsort(labels)


class GroupedBatchDataset:
    """Table stream -> (grouped rows) -> fixed-shape feature batches.

    ``shuffle_buffer_batches`` holds that many batches' worth of rows in a
    window and shuffles the window before emitting, mixing rows across
    files and chunks; with session grouping it permutes whole groups, so a
    session's rows stay together and sorted. ``macro_batches`` assembles
    ``macro x batch_size`` rows per concatenation and slices the step
    batches out of it.

    Resume snapshots: at every drain boundary the iterator records its
    state (the generator's chunk cursor, the pending window, the shuffle
    generator's state, the batches produced); ``snapshot(B)`` pickles the
    newest state at or before consumer batch B, with the number of batches
    to discard after restoring it (fewer than a macro's), and
    ``restore_snapshot`` arms the next iteration to start there, at a cost
    of the pending window, whatever B is. ``request_skip`` asks the
    generator to skip rows by file metadata instead, where the row stream
    is a plain FIFO (no grouping, no shuffle buffer).
    """

    _SNAP_KEEP = 64  # the producer runs ahead of the consumer by its prefetch depth

    def __init__(
        self,
        dataframe_generator,
        features_config: FeaturesConfig,
        batch_size: int,
        limit: Optional[int] = None,
        group_config: Optional[GroupDatasetConfig] = None,
        drop_remainder: bool = True,
        columns: Optional[List[str]] = None,
        shuffle_buffer_batches: int = 0,
        macro_batches: int = 1,
        seed: Optional[int] = None,
    ):
        self._gen = dataframe_generator
        self._features = features_config
        self._batch_size = batch_size
        self._limit = limit
        self._group = group_config if group_config is not None else features_config.group_dataset
        self._drop_remainder = drop_remainder
        self._columns = columns
        self._shuffle_buffer_batches = max(0, shuffle_buffer_batches)
        self._macro_batches = max(1, macro_batches)
        self._seed = seed
        self._snap_lock = threading.Lock()
        self._snaps: List[tuple] = []  # (produced, state)
        self._gen_pieces = 0  # generator tables consumed
        self._restore_state: Optional[dict] = None
        # set by get_host_dataloader when the batcher is the loader
        # (bypass_dataloader): an O(1) resume took effect, and the batches
        # to discard after a snapshot restore
        self.skip_applied = False
        self.discard_batches = 0

    def __getstate__(self):
        """The recipe, for a reader in another process: no lock, no
        recorded states."""
        state = dict(self.__dict__)
        state["_snap_lock"], state["_snaps"] = None, []
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._snap_lock = threading.Lock()

    def _grouping(self) -> bool:
        return self._group is not None and bool(self._group.group_by_columns)

    def request_skip(self, batches: int) -> bool:
        """Ask the generator to skip ``batches`` batches' rows by file
        metadata; False where the caller must replay instead (grouping,
        whose filters change row counts, or a shuffle buffer, whose window
        mixes rows across the cursor)."""
        if self._grouping() or self._shuffle_buffer_batches:
            return False
        if not hasattr(self._gen, "set_skip_rows"):
            return False
        self._gen.set_skip_rows(batches * self._batch_size)
        return True

    def _split_chunk(self, table: Table) -> List[Table]:
        """One generator table -> its pieces: the table itself, or its
        groups within the size limits, each sorted. A table's pieces enter
        the pending window together, so the state at any emission is
        (tables consumed, pending window, shuffle generator)."""
        if not self._grouping():
            return [table]
        g = self._group
        pieces = []
        for rows in group_rows(table, list(g.group_by_columns)):
            n = len(rows)
            if n < g.minimum_group_size or (g.maximum_group_size is not None and n > g.maximum_group_size):
                continue
            piece = take_rows(table, rows)
            if g.sort_by_columns:
                piece = take_rows(piece, sort_order(piece, list(g.sort_by_columns), not g.sort_reverse))
            pieces.append(piece)
        return pieces

    def _record_snap(self, produced: int, pending, pending_rows: int, rng) -> None:
        state = {
            "produced": produced,
            "gen_pieces": self._gen_pieces,
            "pending": list(pending),  # tables are never written to
            "pending_rows": pending_rows,
            "rng_state": rng.get_state() if rng is not None else None,
        }
        with self._snap_lock:
            self._snaps.append((produced, state))
            if len(self._snaps) > self._SNAP_KEEP:
                del self._snaps[: -self._SNAP_KEEP]

    def snapshot(self, consumed_batches: int) -> Optional[bytes]:
        """The pickled resume state for "the consumer has taken N batches",
        or None before the producer has recorded one (the caller replays)."""
        with self._snap_lock:
            best = None
            for produced, state in self._snaps:
                if produced <= consumed_batches and (best is None or produced > best["produced"]):
                    best = state
        if best is None:
            return None
        payload = dict(best)
        payload["discard_batches"] = consumed_batches - best["produced"]
        return pickle.dumps(payload, protocol=4)

    def restore_snapshot(self, blob: bytes) -> int:
        """Arm the next iteration to resume from a ``snapshot`` blob; returns
        the batches the caller must discard after it."""
        self._restore_state = pickle.loads(blob)
        return int(self._restore_state.get("discard_batches", 0))

    def __iter__(self) -> Iterator[Batch]:
        produced = 0
        pending: List[Table] = []
        pending_rows = 0
        grouping = self._grouping()
        rng = (
            np.random.RandomState(0 if self._seed is None else self._seed)
            if self._shuffle_buffer_batches
            else None
        )
        self._gen_pieces = 0
        if self._restore_state is not None:
            st, self._restore_state = self._restore_state, None
            produced = int(st["produced"])
            pending = list(st["pending"])
            pending_rows = int(st["pending_rows"])
            self._gen_pieces = int(st["gen_pieces"])
            if rng is not None and st["rng_state"] is not None:
                rng.set_state(st["rng_state"])
            if hasattr(self._gen, "set_start_chunk"):
                self._gen.set_start_chunk(self._gen_pieces)
            elif self._gen_pieces:
                raise ValueError("snapshot restore requires a generator with set_start_chunk")
        emit_rows = self._batch_size * self._macro_batches
        # keep buffer_rows of lookahead behind every emission, so the shuffle
        # window always spans at least that many future rows
        threshold = emit_rows + self._batch_size * self._shuffle_buffer_batches

        def _emit(table: Table) -> Iterator[Batch]:
            for s in range(0, num_rows(table), self._batch_size):
                yield make_features_compliant(take_rows(table, slice(s, s + self._batch_size)), self._features)

        def _drain(n_rows: int) -> Table:
            nonlocal pending, pending_rows
            if rng is not None and grouping:
                # whole groups move; a group's rows stay sorted
                pending = [pending[j] for j in rng.permutation(len(pending))]
            table = concat_tables(pending)
            if rng is not None and not grouping:
                table = take_rows(table, rng.permutation(num_rows(table)))
            head, rest = take_rows(table, slice(0, n_rows)), take_rows(table, slice(n_rows, None))
            pending_rows = num_rows(rest)
            pending = [rest] if pending_rows else []
            return head

        def _drain_backlog():
            # every drain the window affords; also runs first after a restore,
            # since a state recorded mid-backlog must finish draining before
            # the next table is read
            nonlocal produced
            while pending_rows >= threshold:
                for batch in _emit(_drain(emit_rows)):
                    produced += 1
                    yield batch
                self._record_snap(produced, pending, pending_rows, rng)

        self._record_snap(produced, pending, pending_rows, rng)
        emitted = 0
        for batch in _drain_backlog():
            emitted += 1
            yield batch
            if self._limit is not None and emitted >= self._limit:
                return
        for chunk in self._gen:
            self._gen_pieces += 1
            for piece in self._split_chunk(chunk):
                if self._columns is not None:
                    piece = {k: v for k, v in piece.items() if k in self._columns}
                pending.append(piece)
                pending_rows += num_rows(piece)
            for batch in _drain_backlog():
                emitted += 1
                yield batch
                if self._limit is not None and emitted >= self._limit:
                    return
        # the generator is exhausted: flush whatever full batches remain
        while pending_rows >= self._batch_size:
            n = (pending_rows // self._batch_size) * self._batch_size
            for batch in _emit(_drain(n)):
                produced += 1
                emitted += 1
                yield batch
                if self._limit is not None and emitted >= self._limit:
                    return
            self._record_snap(produced, pending, pending_rows, rng)
        if pending and pending_rows and not self._drop_remainder:
            table = concat_tables(pending)
            n = num_rows(table)
            # pad by repeating rows; '_pad_mask' marks the synthetic tail
            reps = int(np.ceil(self._batch_size / n))
            table = take_rows(concat_tables([table] * reps), slice(0, self._batch_size))
            batch = make_features_compliant(table, self._features)
            batch["_pad_mask"] = np.arange(self._batch_size) >= n
            yield batch
