"""Joint retrieval -> ranking (BASELINE config 4): LTHM user vectors as a
ranker feature.

Port of ``recommendations_tpu/tools/joint_pipeline.py``:
1. encode each user's history into the lookahead-0 query of the most recent
   position, L2-normalized (the retrieval user vector): ``encode_users``;
2. join the vectors onto the impression log as a ``tensor`` feature (zeros
   for a cold user): ``attach_user_embeddings``;
3. ``run_joint``: train the ranker with ``user_emb`` routed to its user
   tower, on batches drawn from numpy's ``RandomState(seed)``.

``user_batches`` cuts a click-log table into full batches of encoder
inputs, each with its raw user ids, and leaves out the last partial one (as
the JAX package's joint encoder does).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Mapping

import numpy as np
import torch

from recommendations_tpu_torch.features.transforms import Table, num_rows, objects, take_rows
from recommendations_tpu_torch.nn.functional import l2_normalize

logger = logging.getLogger(__name__)


def _numeric(batch: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: v for k, v in batch.items() if getattr(v, "dtype", None) is not None and v.dtype.kind in "ifub"}


def user_batches(table: Table, features_config, batch_size: int, id_field: str = "customer_id") -> List[dict]:
    """Full batches of the table's mapped and compliant rows with the raw
    ``id_field`` beside them; a last partial batch is left out."""
    from recommendations_tpu_torch.data.grouping import make_features_compliant

    raw_ids = np.asarray(table[id_field])
    mapped = features_config.default_data_mapper(dict(table))
    out = []
    for s0 in range(0, num_rows(mapped) - batch_size + 1, batch_size):
        host = _numeric(make_features_compliant(take_rows(mapped, slice(s0, s0 + batch_size)), features_config))
        host[id_field] = raw_ids[s0: s0 + batch_size]
        out.append(host)
    return out


@torch.no_grad()
def encode_users(wrapper, user_batches: Iterable[Mapping[str, np.ndarray]],
                 id_field: str = "customer_id") -> Dict[str, np.ndarray]:
    """customer_id (raw string) -> L2-normalized user embedding."""
    table: Dict[str, np.ndarray] = {}
    for batch in user_batches:
        out = wrapper.forward(_numeric(batch))
        emb = l2_normalize(out["next_token_emb"][:, -1, 0, :]).float().cpu().numpy()
        for i, uid in enumerate(batch[id_field]):
            table[str(uid)] = emb[i]
    return table


def attach_user_embeddings(impressions: Table, user_table: Mapping[str, np.ndarray], emb_dim: int,
                           id_column: str = "customer_id", out_column: str = "user_emb") -> Table:
    """The impression log with the user vectors joined on (zeros for a cold
    user)."""
    zero = np.zeros(emb_dim, np.float32)
    out = dict(impressions)
    out[out_column] = objects(user_table.get(str(u), zero) for u in impressions[id_column])
    return out


def run_joint(lthm_wrapper, user_batches, impressions: Table, ranker_config, train_steps: int = 200,
              batch_size: int = 256, seed: int = 0, device="cuda"):
    """Train the ranker on impressions enriched with LTHM user vectors with
    Adam (optax.adam's update): (ranker wrapper, final metrics)."""
    from recommendations_tpu_torch.data.grouping import make_features_compliant
    from recommendations_tpu_torch.models.ranker.wrapper import RankerModelWrapper

    emb_dim = lthm_wrapper.config.product_tower.product_emb_dim
    user_table = encode_users(lthm_wrapper, user_batches)
    logger.info("encoded %d users", len(user_table))
    enriched = attach_user_embeddings(impressions, user_table, emb_dim)
    wrapper = RankerModelWrapper(ranker_config, device=device, seed=seed)
    feats = ranker_config.features
    mapped = feats.default_data_mapper(enriched)
    rs = np.random.RandomState(seed)

    def make_batch():
        idx = rs.randint(0, num_rows(mapped), batch_size)
        return _numeric(make_features_compliant(take_rows(mapped, idx), feats))

    params = [p for p in wrapper.module.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=ranker_config.lr)
    wrapper.module.train()
    metrics = {}
    for _ in range(train_steps):
        loss, metrics, _ = wrapper.loss_and_metrics(make_batch(), None, True)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    wrapper.module.eval()
    return wrapper, {k: float(v) for k, v in metrics.items()}
