"""Host-side transforms that the feature system compiles, on numpy tables.

Port of ``recommendations_tpu/features/transforms.py``. A table is a
``dict[str, np.ndarray]`` of equal-length columns: numeric columns are
numpy arrays, and string, list and tensor columns are object arrays (one
Python string or numpy array per row), which is what the JAX package's
pandas columns hold. Each transform replaces a column of the table in
place, as the JAX package's transforms assign a frame's column; missing
values are ``None`` or a float NaN, as pandas holds them.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np

from recommendations_tpu_torch.features import constants as C
from recommendations_tpu_torch.features.hashing import (
    hash_feature_name_to_int,
    hash_string_to_long,
    hash_strings_to_long,
)

Table = Dict[str, np.ndarray]


def objects(values: Iterable) -> np.ndarray:
    """A 1-D object array of ``values`` (numpy would stack equal-length
    arrays into a 2-D one)."""
    values = list(values)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def num_rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def take_rows(table: Table, index) -> Table:
    """The rows ``index`` (a slice or an integer array) of every column."""
    return {k: v[index] for k, v in table.items()}


def concat_tables(tables) -> Table:
    tables = list(tables)
    if len(tables) == 1:
        return tables[0]
    return {k: np.concatenate([t[k] for t in tables]) for k in tables[0]}


def to_str_column(values: np.ndarray) -> np.ndarray:
    """``str`` of every value, missing values kept missing (pandas' ``astype(str)``)."""
    return objects(None if is_missing(v) else str(v) for v in values)


def pad_array(arr, size: int, pad_token: int = C.CATEGORICAL_VAR_HASH_PAD_TOKEN) -> np.ndarray:
    """Truncate, then right-pad to ``size`` (reference ``feature_utils.py:21-25``)."""
    arr = np.asarray(arr, dtype=np.int64).reshape(-1)[:size]
    t = max(0, size - len(arr))
    return np.pad(arr, (0, t), mode="constant", constant_values=pad_token)


# ----- NA fixing ------------------------------------------------------------


def fix_na_bool(batch: Table, column: str) -> None:
    batch[column] = np.asarray(batch[column]).astype(np.float32)


def fix_na_str(batch: Table, column: str) -> None:
    batch[column] = objects("NA" if is_missing(v) else v for v in batch[column])


def fix_na_int64(batch: Table, column: str, value_to_lower: bool) -> None:
    seed = hash_feature_name_to_int(column)
    na_value = hash_string_to_long("NA", seed, value_to_lower=value_to_lower)
    vals = batch[column]
    if vals.dtype == object or vals.dtype.kind == "f":
        vals = np.array([na_value if is_missing(v) else v for v in vals], dtype=np.int64)
    batch[column] = vals.astype(np.int64)


def fix_na_string_list(batch: Table, column: str) -> None:
    batch[column] = objects([] if v is None else v for v in batch[column])


def fix_na_one_hot_string(batch: Table, column: str) -> None:
    batch[column] = objects(C.ONE_HOT_STRING_DEFAULT if v is None else v for v in batch[column])


def fix_na_tensor(batch: Table, column: str, emb_dim: int) -> None:
    sentinel = np.zeros(emb_dim)
    batch[column] = objects(sentinel if v is None else v for v in batch[column])


def fix_na_tensor_list(batch: Table, column: str, shape: Tuple[int, ...]) -> None:
    sentinel = np.zeros((int(np.prod(shape)),), dtype=np.float32)
    batch[column] = objects(
        sentinel if x is None else np.array(x[0] if hasattr(x[0], "__len__") else x, dtype=np.float32)
        for x in batch[column]
    )


def fix_partial_tensor_list(batch: Table, column: str, shape: Tuple[int, ...]) -> None:
    """Reshape, truncate or zero-extend ragged tensor lists to ``shape``
    (reference ``feature_utils.py:91-102``)."""
    numel = int(np.prod(shape))

    def _func(x):
        x = np.asarray(x, dtype=np.float32)
        if int(np.prod(x.shape)) == numel:
            return x.reshape(shape)
        x = x.reshape(-1, *shape[1:])
        if shape[0] < x.shape[0]:
            return x[: shape[0]]
        residual = (shape[0] - x.shape[0], *shape[1:])
        return np.concatenate((x, np.zeros(residual, dtype=np.float32)), axis=0)

    batch[column] = objects(_func(x) for x in batch[column])


def fill_na(batch: Table) -> None:
    for col, vals in list(batch.items()):
        if vals.dtype.kind == "f":
            batch[col] = np.where(np.isnan(vals), vals.dtype.type(C.NA_NUMERICAL_VALUE), vals)


# ----- structural -----------------------------------------------------------


def rename_column(batch: Table, src_column: str, target_column: str) -> None:
    """The column keeps its place, as pandas' ``rename``."""
    items = [(target_column if k == src_column else k, v) for k, v in batch.items()]
    batch.clear()
    batch.update(items)


def copy_value(batch: Table, src_column: str, target_column: str) -> None:
    batch[target_column] = batch[src_column]


# ----- value transforms -----------------------------------------------------


def create_array_one_hot_feature(batch: Table, column: str) -> None:
    """'0010...' string -> indices of the '1's, padded to a fixed length
    with -1 (reference ``feature_utils.py:117-123``)."""
    out = []
    for val in batch[column]:
        chars = np.frombuffer(str(val).encode("ascii", "replace"), dtype=np.uint8)
        indices = np.nonzero(chars == ord(C.ONE_HOT_POSITIVE_VALUE))[0]
        out.append(
            pad_array(
                indices[: C.ONE_HOT_STRING_ONES_MAX_LENGTH],
                size=C.ONE_HOT_STRING_ONES_MAX_LENGTH,
                pad_token=C.ONE_HOT_STRING_ONES_PAD_TOKEN,
            )
        )
    batch[column] = objects(out)


def _to_number(v) -> float:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return -1.0
    return -1.0 if math.isnan(f) else f


def box_lat_long_feature(batch: Table, column: str) -> None:
    batch[column] = np.asarray([_to_number(v) for v in batch[column]], dtype=np.float64)


def transform_value_to_lower(batch: Table, column: str) -> None:
    batch[column] = objects(str(v).lower() for v in batch[column])


def xxhash_categorical_values_to_number(batch: Table, column: str, value_to_lower: bool) -> None:
    seed = hash_feature_name_to_int(column)
    batch[column] = hash_strings_to_long([str(v) for v in batch[column]], seed, value_to_lower)


def handle_categorical_history_feature(
    batch: Table,
    column: str,
    hash_ids: bool,
    history_length: int,
    history_id_feature_name: str,
    remove_history_id_from_history: bool = False,
) -> None:
    """Hash, leak-filter, truncate and pad a history column (reference
    ``feature_utils.py:149-179``): history ids are hashed with the seed of
    the current-item feature, so they share its id space; the current item
    can be dropped from its own history (label-leak removal); the result is
    capped and right-padded to ``history_length``."""
    if not hash_ids and not remove_history_id_from_history:
        truncate_and_pad_to_fix_len(batch, column, history_length)
        return

    seed = hash_feature_name_to_int(history_id_feature_name)
    processed = []
    for current_id, history in zip(batch[history_id_feature_name], batch[column]):
        if hash_ids:
            hist = hash_strings_to_long([str(h) for h in history], seed, value_to_lower=False)
        else:
            hist = np.asarray(history, dtype=np.int64)
        if remove_history_id_from_history:
            hist = hist[hist != current_id]
        processed.append(pad_array(hist[:history_length], size=history_length))
    batch[column] = objects(processed)


def truncate_and_pad_to_fix_len(batch: Table, column: str, length: int) -> None:
    batch[column] = objects(pad_array(x, size=length) for x in batch[column])
