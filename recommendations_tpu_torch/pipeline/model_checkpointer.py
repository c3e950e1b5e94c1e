"""Mid-training checkpoint callback holder.

Port of ``recommendations_tpu/pipeline/model_checkpointer.py`` (reference
``commons/pipeline/model_checkpointer.py:7-15``): routes the in-training
state and its metrics into the pipeline's export.
"""

from __future__ import annotations

from typing import Any, Callable, Optional


class ModelCheckpointer:
    def __init__(self, checkpoint_fn: Callable[..., None]):
        self._fn = checkpoint_fn

    def checkpoint(self, state: Optional[Any], result_df=None, result_extra_day_df=None) -> None:
        self._fn(state, result_df, result_extra_day_df)
