"""Ranker (factorized DLRM) config as a dataclass.

Port of ``recommendations_tpu/models/ranker/config.py``: the same fields and
defaults, registered under (ranker, ranker_model). Features go to the
query, product and user towers by their ``tower_name``, over every feature
list (tensor features included); an explicit ``query_features``,
``item_features`` or ``user_features`` list overrides the routing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from recommendations_tpu_torch.config.base import build_fields
from recommendations_tpu_torch.config.model_config import ModelConfig, register_model_config
from recommendations_tpu_torch.features.feature_config import FeaturesConfig, Task


@register_model_config
@dataclass
class RankerModelConfig(ModelConfig):
    features: FeaturesConfig = field(default_factory=FeaturesConfig)
    kind: str = "ranker"
    type: str = "factorized_dlrm"
    name: str = "ranker_model"
    version: str = "v1"
    tasks: Optional[List[Task]] = None
    emb_dim: int = 64
    # explicit overrides; the default routing is by Feature.tower_name
    query_features: Optional[List[str]] = None
    item_features: Optional[List[str]] = None
    user_features: Optional[List[str]] = None
    tower_hidden: Tuple[int, ...] = (256, 128)
    tower_dim: int = 64
    top_hidden: Tuple[int, ...] = (256, 128)
    num_embeddings_default: int = 2**22
    use_qr_embeddings: bool = True
    interaction_self: bool = False  # the self-dots in the pairwise block
    lr: float = 1e-3
    weight_decay: float = 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "RankerModelConfig":
        """Each field coerced by its annotation (the features, the tasks);
        unknown keys ignored, as pydantic ignores them."""
        return build_fields(cls, dict(d))

    def _routed(self, tower: str) -> List[str]:
        f = self.features
        feats = (
            f.categorical_features + f.numerical_features + f.bool_features + f.timestamp_features
            + f.one_hot_string_features + f.lat_lng_features + f.tensor_features
        )
        return [x.name for x in feats if x.tower_name.value == tower]

    @property
    def product_features_list(self) -> List[str]:
        return self.item_features if self.item_features is not None else self._routed("product")

    @property
    def query_features_list(self) -> List[str]:
        return self.query_features if self.query_features is not None else self._routed("query")

    @property
    def user_features_list(self) -> List[str]:
        return self.user_features if self.user_features is not None else self._routed("user")

    @property
    def task_list(self) -> List[Task]:
        return self.tasks or []

    def get_builder(self, stats: Any = None, device="cuda"):
        from recommendations_tpu_torch.models.ranker.builder import RankerModelBuilder

        return RankerModelBuilder(stats, self, device=device)
