"""Feature-system constants: the hashing and padding contract.

A copy of ``recommendations_tpu/features/constants.py``.

Values are part of the wire format between offline feature generation, the
training input pipeline, and serving, and must match the reference exactly
(``commons/feature_utils.py:7-14``).
"""

MAX_LONG_VALUE_PLUS_ONE = 2**63
CATEGORICAL_VAR_HASH_PAD_TOKEN = 0
NA_NUMERICAL_VALUE = -1.0
ONE_HOT_STRING_SIZE = 470
ONE_HOT_STRING_ONES_MAX_LENGTH = 100
ONE_HOT_STRING_ONES_PAD_TOKEN = -1
ONE_HOT_POSITIVE_VALUE = "1"
ONE_HOT_STRING_DEFAULT = "0" * ONE_HOT_STRING_SIZE
