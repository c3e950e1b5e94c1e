"""The offline KNN retrieval eval: recall@k over the product catalog.

Port of ``recommendations_tpu/pipeline/knn_eval.py``:

1. encode the catalog: product ids -> the product tower's L2-normalized
   retrieval embeddings (the ``current_token_emb`` space), in batches of
   8192, the last one padded; kept on the host;
2. encode held-out users: the lookahead-0 query at output position s - 1,
   whose label is the history's most recent item, ``current_token_ids[:, s-1]``;
3. score the catalog in chunks of ``knn_catalog_chunk_rows`` on the device
   with a running top-k merge (plain ``torch.matmul`` and ``torch.topk``, as
   the JAX package computes them outside Pallas);
4. recall@k: the label is among the top k, over users with at least 2 real
   events.

The product path is the wrapper's own ``product_emb_module`` and
``product_tower``, so it is the module ``LTHMEncoder`` chose (the pretrained
one, or a fresh KShift table or fused record), with its rows in float32 as
the JAX package's catalog encoder builds its embedding modules (without the
compute dtype). The wrapper holds the weights.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from recommendations_tpu_torch.nn.functional import l2_normalize

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def _float32_rows(embedding: torch.nn.Module):
    saved = embedding.compute_dtype
    embedding.compute_dtype = None
    try:
        yield embedding
    finally:
        embedding.compute_dtype = saved


@torch.no_grad()
def encode_catalog(wrapper, product_ids: np.ndarray, batch_size: int = 8192) -> np.ndarray:
    """ids (N,) int64 -> L2-normalized retrieval embeddings (N, D) float32,
    on the host."""
    module = wrapper.module
    out = []
    n = len(product_ids)
    with _float32_rows(module.product_emb_module) as embedding:
        for i in range(0, n, batch_size):
            chunk = np.asarray(product_ids[i: i + batch_size], np.int64)
            pad = batch_size - len(chunk)
            if pad:
                chunk = np.pad(chunk, (0, pad))
            ids = torch.from_numpy(chunk).to(wrapper.device)
            _, prod_emb, _ = module.product_tower(ids, embedding(ids))
            out.append(l2_normalize(prod_emb).cpu().numpy()[: batch_size - pad])
    return np.concatenate(out, axis=0)


@torch.no_grad()
def knn_query(wrapper, batch: Mapping[str, np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(query embeddings (B, D), labels (B,), real-event counts (B,)) of a
    user batch, on the device."""
    out = wrapper.forward({k: v for k, v in batch.items() if np.asarray(v).dtype != object})
    q = out["next_token_emb"][:, :, 0, :]  # the lookahead-0 head (B, S+1, D)
    mask = out["current_token_mask"]  # (B, S)
    s = mask.shape[1]
    count = (~mask).to(torch.int32).sum(dim=1)
    # output index s-1 sees the tokens before s-1: it predicts the held-out last item
    return l2_normalize(q[:, s - 1, :]), out["current_token_ids"][:, s - 1], count


def _catalog_chunks(catalog_emb: np.ndarray, catalog_ids: np.ndarray, chunk: int, device):
    """Fixed-size chunks (the last one padded, its pad rows not valid) on the
    device."""
    n = len(catalog_ids)
    for i in range(0, n, chunk):
        ce, ci = catalog_emb[i: i + chunk], catalog_ids[i: i + chunk]
        pad = chunk - len(ci)
        valid = np.ones(chunk, bool)
        if pad:
            ce = np.pad(ce, ((0, pad), (0, 0)))
            ci = np.pad(ci, (0, pad))
            valid[chunk - pad:] = False
        yield (torch.from_numpy(np.ascontiguousarray(ce)).to(device), torch.from_numpy(ci).to(device),
               torch.from_numpy(valid).to(device))


@torch.no_grad()
def _merge_chunk(qe, cat_emb, cat_ids, valid, best_v, best_i, max_k: int):
    """Score one catalog chunk and fold it into the running per-query top-k."""
    scores = torch.where(valid[None, :], qe @ cat_emb.T, float("-inf"))  # (B, chunk)
    v, idx = torch.topk(scores, min(max_k, scores.shape[1]), dim=1)
    vv = torch.cat([best_v, v], dim=1)
    ii = torch.cat([best_i, cat_ids[idx]], dim=1)
    v2, sel = torch.topk(vv, max_k, dim=1)
    return v2, torch.gather(ii, 1, sel)


def chunked_topk(qe: torch.Tensor, chunks, max_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``max_k`` (scores, ids) of the queries over every chunk, by a
    running merge."""
    b = qe.shape[0]
    best_v = torch.full((b, max_k), float("-inf"), dtype=torch.float32, device=qe.device)
    best_i = torch.zeros((b, max_k), dtype=torch.int64, device=qe.device)
    for ce, ci, valid in chunks:
        best_v, best_i = _merge_chunk(qe, ce, ci, valid, best_v, best_i, max_k)
    return best_v, best_i


def knn_recall(
    wrapper,
    user_batches: List[Dict[str, np.ndarray]],
    catalog_ids: np.ndarray,
    top_k_list: List[int],
    catalog_chunk_rows: int = 1 << 20,
) -> List[Dict[str, float]]:
    """recall@k rows ``{"k", "recall", "queries"}`` for held-out last-item
    retrieval. The catalog goes through in row chunks of
    ``catalog_chunk_rows``, so device memory holds ``chunk_rows x D + B x
    chunk_rows`` whatever the catalog's size (up to 8 chunks stay on the
    device across query batches)."""
    catalog_emb = encode_catalog(wrapper, catalog_ids)  # host (N, D)
    max_k = max(top_k_list)
    n = len(catalog_ids)
    chunk = int(min(catalog_chunk_rows, n))
    cached = list(_catalog_chunks(catalog_emb, catalog_ids, chunk, wrapper.device)) if n <= chunk * 8 else None

    hits = {k: 0 for k in top_k_list}
    total = 0
    for batch in user_batches:
        qe, label, count = knn_query(wrapper, batch)
        chunks = cached if cached is not None else _catalog_chunks(catalog_emb, catalog_ids, chunk, wrapper.device)
        _, best_i = chunked_topk(qe, chunks, max_k)
        valid_q = count.cpu().numpy() >= 2
        lab = label.cpu().numpy()
        ti = best_i.cpu().numpy()
        for k in top_k_list:
            hits[k] += int(((ti[:, :k] == lab[:, None]).any(axis=1) & valid_q).sum())
        total += int(valid_q.sum())
    return [{"k": k, "recall": hits[k] / max(total, 1), "queries": total} for k in top_k_list]


def run_knn_eval(wrapper, pipeline_config) -> Optional[List[Dict[str, float]]]:
    """The pipeline's hook: the catalog (``knn_catalog_table_path``, or the
    ids of the eval stream) and the query users from the validation paths."""
    from recommendations_tpu_torch.data.generator import get_data_loader_strategy
    from recommendations_tpu_torch.data.loader import get_host_dataloader
    from recommendations_tpu_torch.data.paths import get_val_data_paths

    cfg = pipeline_config
    if cfg.eval is None or cfg.eval.skip_knn_eval:
        return None
    feats = cfg.model.features
    strategy = get_data_loader_strategy(
        cfg.data_loader, feats.get_input_columns(), lambda kind: feats.default_data_mapper,
    )
    val_paths = get_val_data_paths(cfg.dataset)
    if not val_paths:
        return None
    loader = get_host_dataloader(
        kind="val", worker_id=0, paths=val_paths,
        batch_size=cfg.eval.eval_batch_size,
        num_steps=cfg.eval.max_eval_steps,
        data_loader_strategy=strategy, features_config=feats,
        fs_config=cfg.dataset.filesystem_config,
    )
    batches = list(loader)
    if not batches:
        return None
    all_ids = load_catalog_ids(cfg)
    if all_ids is None:
        # the distinct ids of the eval stream (sampling bias: only items that
        # appear in validation histories can be retrieved)
        ids_key = feats.categorical_history_features[0].name
        all_ids = np.unique(np.concatenate([b[ids_key].reshape(-1) for b in batches]))
        all_ids = all_ids[all_ids != 0]
    rows = knn_recall(wrapper, batches, all_ids, cfg.eval.knn_top_k_list,
                      catalog_chunk_rows=cfg.eval.knn_catalog_chunk_rows)
    logger.info("knn eval: %s", rows)
    return rows


def load_catalog_ids(pipeline_config) -> Optional[np.ndarray]:
    """The product catalog of ``knn_catalog_table_path`` (parquet, through
    the dataset's store): string ids hashed with the history feature's
    contract (``features/hashing.py``), so they live in the model's id
    space; an int64 column passes through unhashed. Unique, without 0."""
    cfg = pipeline_config
    path = cfg.eval.knn_catalog_table_path
    if not path:
        return None
    from recommendations_tpu_torch.data.data_store import DataStoreAccessor
    from recommendations_tpu_torch.features.hashing import hash_feature_name_to_int, hash_strings_to_long

    feat = cfg.model.features.categorical_history_features[0]
    col = cfg.eval.knn_catalog_id_column or feat.history_id_feature_name
    store = DataStoreAccessor.get_instance(cfg.dataset.filesystem_config)
    table = store.read_single_parquet_file(path, columns=[col])
    if table is None or len(table[col]) == 0:
        logger.warning("knn catalog table %s empty/unreadable", path)
        return None
    values = np.asarray(table[col])
    if np.issubdtype(values.dtype, np.integer):
        ids = values.astype(np.int64)
    else:
        seed = hash_feature_name_to_int(feat.history_id_feature_name)
        ids = hash_strings_to_long([str(v) for v in values], seed, value_to_lower=False)
    ids = np.unique(ids)
    return ids[ids != 0]
