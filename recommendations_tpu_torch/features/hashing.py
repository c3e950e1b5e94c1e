"""xxHash feature hashing.

Port of ``recommendations_tpu/features/hashing.py``, the same contract
(reference ``commons/feature_utils.py:36-46``):
- a feature's seed is ``xxh32(lowercase(feature_name), 0)``;
- a value's hash is ``xxh64(str(value), seed) - 2**63``, over the whole
  int64 range.

Every hash goes through the C++ batch kernel of ``native/``, built at first
use; the ``xxhash`` package is not needed.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from recommendations_tpu_torch import native
from recommendations_tpu_torch.features.constants import MAX_LONG_VALUE_PLUS_ONE


def hash_feature_name_to_int(feature_name: str) -> int:
    return native.xxh32(feature_name.lower().encode("utf-8"), 0)


def hash_string_to_long(arg, seed: int, value_to_lower: bool) -> int:
    arg = str(arg)
    if value_to_lower:
        arg = arg.lower()
    return native.xxh64(arg.encode("utf-8"), seed) - MAX_LONG_VALUE_PLUS_ONE


def hash_strings_to_long(values: Iterable, seed: int, value_to_lower: bool) -> np.ndarray:
    """Every value's hash, as an int64 array."""
    return native.hash_strings_to_long(values, seed, value_to_lower)
