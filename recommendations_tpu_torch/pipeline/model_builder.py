"""Model-builder seam - reference ``commons/pipeline/model_builder.py:7-13``.

Port of ``recommendations_tpu/pipeline/model_builder.py``.
"""

from __future__ import annotations

import abc
from typing import Any, Optional


class ModelBuilder(abc.ABC):
    def __init__(self, stats: Optional[Any] = None):
        self.stats = stats

    @abc.abstractmethod
    def build(self):
        """The model wrapper, its weights on its device."""
