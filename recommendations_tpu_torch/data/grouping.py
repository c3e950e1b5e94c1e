"""Fixed-shape batches from a stream of tables.

Port of ``recommendations_tpu/data/grouping.py`` (reference
``commons/data/torch_data_loader.py:15-141``): ``make_features_compliant``
turns a batch's columns into dense arrays per feature kind, and
``GroupedBatchDataset`` cuts the stream of tables into batches of exactly
``batch_size`` rows (the last partial batch dropped, or padded and masked),
with the shuffle buffer and the macro batches of the JAX package. Its
resume snapshots and session grouping (``group_dataset``) are not ported
yet (ROADMAP, port queue item 6b).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from recommendations_tpu_torch.features.feature_config import FeaturesConfig, GroupDatasetConfig
from recommendations_tpu_torch.features.transforms import Table, concat_tables, num_rows, take_rows

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


class GroupedBatchDataset:
    """Table stream -> fixed-shape feature batches.

    ``shuffle_buffer_batches`` holds that many batches' worth of rows in a
    window and shuffles the window before emitting, mixing rows across
    files and chunks. ``macro_batches`` assembles ``macro x batch_size``
    rows per concatenation and slices the step batches out of it.
    """

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
        group = group_config if group_config is not None else features_config.group_dataset
        if group is not None and group.group_by_columns:
            raise NotImplementedError("session grouping (group_dataset) is not ported yet: ROADMAP, port queue item 6b")
        self._gen = dataframe_generator
        self._features = features_config
        self._batch_size = batch_size
        self._limit = limit
        self._drop_remainder = drop_remainder
        self._columns = columns
        self._shuffle_buffer_batches = max(0, shuffle_buffer_batches)
        self._macro_batches = max(1, macro_batches)
        self._seed = seed

    def __iter__(self) -> Iterator[Batch]:
        pending: List[Table] = []
        pending_rows = 0
        rng = (
            np.random.RandomState(0 if self._seed is None else self._seed)
            if self._shuffle_buffer_batches
            else None
        )
        emit_rows = self._batch_size * self._macro_batches
        # keep buffer_rows of lookahead behind every emission, so the shuffle
        # window always spans at least that many future rows
        threshold = emit_rows + self._batch_size * self._shuffle_buffer_batches

        def _emit(table: Table) -> Iterator[Batch]:
            for s in range(0, num_rows(table), self._batch_size):
                yield make_features_compliant(take_rows(table, slice(s, s + self._batch_size)), self._features)

        def _drain(n_rows: int) -> Table:
            nonlocal pending, pending_rows
            table = concat_tables(pending)
            if rng is not None:
                table = take_rows(table, rng.permutation(num_rows(table)))
            head, rest = take_rows(table, slice(0, n_rows)), take_rows(table, slice(n_rows, None))
            pending_rows = num_rows(rest)
            pending = [rest] if pending_rows else []
            return head

        emitted = 0
        for chunk in self._gen:
            if self._columns is not None:
                chunk = {k: v for k, v in chunk.items() if k in self._columns}
            pending.append(chunk)
            pending_rows += num_rows(chunk)
            while pending_rows >= threshold:
                for batch in _emit(_drain(emit_rows)):
                    emitted += 1
                    yield batch
                    if self._limit is not None and emitted >= self._limit:
                        return
        # the generator is exhausted: flush whatever full batches remain
        while pending_rows >= self._batch_size:
            n = (pending_rows // self._batch_size) * self._batch_size
            for batch in _emit(_drain(n)):
                emitted += 1
                yield batch
                if self._limit is not None and emitted >= self._limit:
                    return
        if pending and pending_rows and not self._drop_remainder:
            table = concat_tables(pending)
            n = num_rows(table)
            # pad by repeating rows; '_pad_mask' marks the synthetic tail
            reps = int(np.ceil(self._batch_size / n))
            table = take_rows(concat_tables([table] * reps), slice(0, self._batch_size))
            batch = make_features_compliant(table, self._features)
            batch["_pad_mask"] = np.arange(self._batch_size) >= n
            yield batch
