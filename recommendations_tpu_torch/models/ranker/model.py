"""Factorized DLRM: feature towers -> pairwise interactions -> task heads.

Port of ``recommendations_tpu/models/ranker/model.py``, in float32 as
there (the trainer's ``precision`` is read by no code path of the JAX
package, so the ranker is never cast). Every feature encodes to ``emb_dim``
(``FeatureEncoder``); the query, product and user towers each stack their
features' embeddings and summarize them through an MLP; the pairwise
interaction of all the stacked embeddings is one batched product F . F^T,
of which the upper triangle (without the diagonal unless
``interaction_self``) is gathered; the tower summaries and the
interactions feed a top MLP with one head per task. Module and parameter
names follow the JAX package's, so its variables convert one to one.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from recommendations_tpu_torch.features.feature_config import FeatureKind
from recommendations_tpu_torch.models.ranker.config import RankerModelConfig
from recommendations_tpu_torch.nn.attention import Dense
from recommendations_tpu_torch.nn.embeddings import (
    FlatEmbedding,
    PatternFromTimelocal,
    QREmbedding,
    gather_rows,
    init_param,
)
from recommendations_tpu_torch.nn.functional import gelu_tanh

ONE_HOT_BAG_ROWS = 512


def _width(feature) -> int:
    """The flattened width of a numeric feature's value: 1, a lat-long's 2,
    a tensor feature's product of its shape."""
    if feature.kind == FeatureKind.Tensor:
        n = 1
        for s in feature.get_emb_dim_as_shape():
            n *= int(s)
        return n
    return 2 if feature.kind == FeatureKind.LatLong else 1


class FeatureEncoder(nn.Module):
    """One named feature -> (B, emb_dim), by its kind:

    - categorical: a QR or flat table (``emb``) per the feature's
      ``embedding_tables`` entry, else the config's default rows and kind;
    - timestamp: hour-of-day plus day-of-week (``hod``, ``dow``);
    - one-hot string: a (512, d) bag (``bag``) summed over the ids >= 0, each
      id clipped into the bag;
    - numerical, lat-long and bool: sign(x) log1p|x|, then a projection
      (``proj``); a tensor feature: the projection alone."""

    def __init__(self, config: RankerModelConfig, feature_name: str, generator: torch.Generator):
        super().__init__()
        feats = config.features
        feature = feats.features_map[feature_name]
        self.kind = feature.kind
        d = config.emb_dim
        if self.kind == FeatureKind.Categorical:
            table = feats.embedding_tables.get(getattr(feature, "emb_table_name", None) or "", None)
            n = table.num_embeddings if table else config.num_embeddings_default
            use_qr = table.use_qr if table else config.use_qr_embeddings
            self.emb = QREmbedding(n, d, generator) if use_qr else FlatEmbedding(n, d, generator)
        elif self.kind == FeatureKind.Timestamp:
            self.hod = PatternFromTimelocal(3600, 24, d, generator)
            self.dow = PatternFromTimelocal(86400, 7, d, generator)
        elif self.kind == FeatureKind.OneHotString:
            self.bag = init_param((ONE_HOT_BAG_ROWS, d), 0.02, generator)
        else:
            self.proj = Dense(_width(feature), d, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kind = self.kind
        if kind == FeatureKind.Categorical:
            return self.emb(x)
        if kind == FeatureKind.Timestamp:
            return self.hod(x) + self.dow(x)
        if kind == FeatureKind.OneHotString:
            rows = gather_rows(self.bag, x.clamp(0, ONE_HOT_BAG_ROWS - 1).to(torch.int64))  # (B, L, d)
            return torch.sum(rows * (x >= 0)[..., None], dim=-2)
        xf = x.float().reshape(x.shape[0], -1)
        if kind in (FeatureKind.Numerical, FeatureKind.LatLong, FeatureKind.Bool):
            xf = torch.sign(xf) * torch.log1p(torch.abs(xf))
        return self.proj(xf)


class Tower(nn.Module):
    """The features' embeddings stacked (B, F, d), flattened through the
    hidden GELU layers ``h{i}`` and ``out``: (summary (B, tower_dim), the
    stacked embeddings)."""

    def __init__(self, config: RankerModelConfig, feature_names: Sequence[str], generator: torch.Generator):
        super().__init__()
        self.feature_names = tuple(feature_names)
        for f in self.feature_names:
            self.add_module(f"enc_{f}", FeatureEncoder(config, f, generator))
        width = len(self.feature_names) * config.emb_dim
        self.n_hidden = len(config.tower_hidden)
        for i, w in enumerate(config.tower_hidden):
            self.add_module(f"h{i}", Dense(width, w, generator))
            width = w
        self.out = Dense(width, config.tower_dim, generator)

    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        stacked = torch.stack([getattr(self, f"enc_{f}")(batch[f]) for f in self.feature_names], dim=1)
        h = stacked.reshape(stacked.shape[0], -1)
        for i in range(self.n_hidden):
            h = gelu_tanh(getattr(self, f"h{i}")(h))
        return self.out(h), stacked


class FactorizedDLRM(nn.Module):
    """The towers in the order query, product, user (a tower with no
    feature is left out), the (B, F, F) interaction in float32, the top MLP
    ``top{i}`` and a head ``head_{task}`` per task; the output has each
    task's logits and ``_representation``, the top MLP's last layer."""

    TOWERS = ("query", "product", "user")

    def __init__(self, config: RankerModelConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        lists = {"query": config.query_features_list, "product": config.product_features_list,
                 "user": config.user_features_list}
        self.towers: List[str] = [t for t in self.TOWERS if lists[t]]
        if not self.towers:
            raise ValueError("ranker has no routed features (check tower_name tags)")
        n_feats = 0
        for t in self.towers:
            self.add_module(f"{t}_tower", Tower(config, lists[t], generator))
            n_feats += len(lists[t])
        iu, ju = torch.triu_indices(n_feats, n_feats, offset=0 if config.interaction_self else 1)
        self.register_buffer("iu", iu.to(generator.device), persistent=False)
        self.register_buffer("ju", ju.to(generator.device), persistent=False)
        width = len(self.towers) * config.tower_dim + iu.shape[0]
        self.n_top = len(config.top_hidden)
        for i, w in enumerate(config.top_hidden):
            self.add_module(f"top{i}", Dense(width, w, generator))
            width = w
        for task in config.task_list:
            self.add_module(f"head_{task.name}", Dense(width, task.num_labels, generator))

    def forward(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        summaries, embs = [], []
        for t in self.towers:
            s, e = getattr(self, f"{t}_tower")(batch)
            summaries.append(s)
            embs.append(e)
        feats = torch.cat(embs, dim=1).float()  # (B, F, d)
        inter = torch.bmm(feats, feats.transpose(1, 2))  # one batched product: a plain matmul, no kernel
        pairwise = inter[:, self.iu, self.ju]
        h = torch.cat(summaries + [pairwise], dim=-1)
        for i in range(self.n_top):
            h = gelu_tanh(getattr(self, f"top{i}")(h))
        out = {task.name: getattr(self, f"head_{task.name}")(h) for task in self.config.task_list}
        out["_representation"] = h
        return out
