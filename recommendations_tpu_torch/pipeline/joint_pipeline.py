"""The joint retrieval -> ranking product pipeline (BASELINE config 4).

Port of ``recommendations_tpu/pipeline/joint_pipeline.py``. One config
(``configs/joint_train.yaml``) drives:

1. the retrieval stage: a ``TrainerPipeline`` run of the LTHM config;
2. the encode stage: every click-log user through the trained encoder (the
   lookahead-0 query of the last position, the retrieval user vector) and
   every impression sku through the product tower
   (``knn_eval.encode_catalog``). As in the JAX package, each file's last
   partial batch of users is left out (a static batch shape there: "tail
   users are a sliver"), so the user table has the JAX package's keys;
3. the enrich stage: the ranking parquet rewritten with ``user_emb`` and
   ``item_emb`` columns joined on (zeros for an id with no vector);
4. the ranking stage: a ``TrainerPipeline`` run of the ranker config over
   the enriched files, the embeddings read as ``tensor`` features;
5. the ablation arm (``ablation``): the same ranking run with both columns
   zeroed; ``auc_uplift_<task>`` = val AUC with - val AUC ablated. With the
   validation split drawn from held-out users (the synth stage does this),
   it is the held-out-user uplift.

Parquet goes through ``pyarrow`` (no pandas); every stage runs on the
pipeline's device.
"""

from __future__ import annotations

import copy
import logging
import os
import shutil
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np

from recommendations_tpu_torch.config.base import build_fields
from recommendations_tpu_torch.config.pipeline_config import TrainerPipelineConfig

logger = logging.getLogger(__name__)


@dataclass
class JointEncodeConfig:
    batch_size: int = 64
    user_id_column: str = "customer_id"
    item_id_column: str = "product_id"
    user_emb_column: str = "user_emb"
    item_emb_column: str = "item_emb"


@dataclass
class JointSynthConfig:
    """The demo-data stage: write the synthetic joint dataset when the paths
    are absent. The ranking validation file is drawn from held-out users, so
    the ranking stage's val AUC is the held-out-user metric."""

    enabled: bool = False
    root: str = "/tmp/joint_train_data"
    regenerate: bool = False
    users: int = 1024
    products: int = 600
    clusters: int = 8
    history_len: int = 64
    files_per_date: int = 4
    train_rows: int = 30_000
    val_rows: int = 6_000
    heldout_fraction: float = 0.2
    p_in_cluster_jump: float = 0.35
    seed: int = 0


@dataclass
class JointPipelineConfig:
    retrieval: TrainerPipelineConfig
    ranking: TrainerPipelineConfig
    joint: bool = True
    encode: JointEncodeConfig = field(default_factory=JointEncodeConfig)
    synth: JointSynthConfig = field(default_factory=JointSynthConfig)
    # where the embedding-enriched ranking parquet is written
    enriched_dir: str = "/tmp/joint_train_enriched"
    # run the zero-embedding arm and report auc_uplift
    ablation: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "JointPipelineConfig":
        d = dict(d)
        for key in ("retrieval", "ranking"):
            if isinstance(d.get(key), dict):
                d[key] = TrainerPipelineConfig.from_dict(d[key])
        if isinstance(d.get("encode"), dict):
            d["encode"] = build_fields(JointEncodeConfig, d["encode"])
        if isinstance(d.get("synth"), dict):
            d["synth"] = build_fields(JointSynthConfig, d["synth"])
        return build_fields(cls, d)


def _generate_synth(jc: JointPipelineConfig) -> None:
    """Write the demo joint dataset: the click log (retrieval) and the
    cluster-match impressions (ranking; validation from held-out users)."""
    from recommendations_tpu_torch.features.transforms import concat_tables, objects
    from recommendations_tpu_torch.tools.synth_data import (
        _pad_lists,
        make_click_log,
        make_cluster_ranking_log,
        user_cluster_map,
        write_parquet_table,
    )

    s = jc.synth
    click_dir = os.path.join(s.root, "clicks", "date=20240101")
    rank_train_dir = os.path.join(s.root, "impressions", "date=20240101")
    rank_val_dir = os.path.join(s.root, "impressions_val", "date=20240102")
    if os.path.isdir(click_dir) and not s.regenerate:
        logger.info("joint synth data present under %s", s.root)
        return
    for d in (click_dir, rank_train_dir, rank_val_dir):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d, exist_ok=True)

    users_per_file = max(1, s.users // s.files_per_date)
    clicks = []
    for i in range(s.files_per_date):
        table = make_click_log(
            num_users=users_per_file, history_len=s.history_len, num_products=s.products,
            num_clusters=s.clusters, seed=s.seed + i, p_in_cluster_jump=s.p_in_cluster_jump,
        )
        # decorrelate user ids across files
        table["customer_id"] = objects(f"user_{i}_{u}" for u in range(len(table["customer_id"])))
        padded = _pad_lists(table, s.history_len)
        write_parquet_table(padded, os.path.join(click_dir, f"part-{i:05d}.parquet"))
        clicks.append(padded)
    click_table = concat_tables(clicks)

    user_cluster = user_cluster_map(click_table, s.products, s.clusters)
    all_users = list(user_cluster)
    perm = np.random.RandomState(5).permutation(len(all_users))
    n_hold = max(1, int(len(all_users) * s.heldout_fraction))
    heldout = [all_users[i] for i in perm[:n_hold]]
    train_u = [all_users[i] for i in perm[n_hold:]]

    rows_per_file = max(1, s.train_rows // s.files_per_date)
    for i in range(s.files_per_date):
        table, _ = make_cluster_ranking_log(user_cluster, train_u, s.products, s.clusters,
                                            num_rows=rows_per_file, seed=3 + i)
        write_parquet_table(table, os.path.join(rank_train_dir, f"part-{i:05d}.parquet"))
    val_table, _ = make_cluster_ranking_log(user_cluster, heldout, s.products, s.clusters,
                                            num_rows=s.val_rows, seed=77)
    write_parquet_table(val_table, os.path.join(rank_val_dir, "part-00000.parquet"))
    logger.info("joint synth data: %d users (%d held out), %d train rows, %d val rows",
                len(all_users), n_hold, s.train_rows, s.val_rows)


def _ranking_paths(rk: TrainerPipelineConfig) -> List[str]:
    from recommendations_tpu_torch.data.paths import get_train_data_paths, get_val_data_paths

    return list(get_train_data_paths(rk.dataset)) + list(get_val_data_paths(rk.dataset) or [])


def _encode_tables(jc: JointPipelineConfig, wrapper) -> Dict[str, Dict[str, np.ndarray]]:
    """user id -> retrieval vector; sku -> product-tower embedding."""
    from recommendations_tpu_torch.data.data_store import DataStoreAccessor
    from recommendations_tpu_torch.data.paths import get_train_data_paths
    from recommendations_tpu_torch.features.hashing import hash_feature_name_to_int, hash_strings_to_long
    from recommendations_tpu_torch.pipeline.knn_eval import encode_catalog
    from recommendations_tpu_torch.tools.joint_pipeline import encode_users, user_batches

    rcfg = jc.retrieval
    feats = rcfg.model.features
    store = DataStoreAccessor.get_instance(rcfg.dataset.filesystem_config)
    user_table: Dict[str, np.ndarray] = {}
    for path in get_train_data_paths(rcfg.dataset):
        table = store.read_single_parquet_file(path)
        batches = user_batches(table, feats, jc.encode.batch_size, jc.encode.user_id_column)
        user_table.update(encode_users(wrapper, batches, jc.encode.user_id_column))

    # the candidate skus of the RANKING dataset (train and val)
    skus: set = set()
    for p in _ranking_paths(jc.ranking):
        table = store.read_single_parquet_file(p)
        skus.update(str(x) for x in np.unique(table[jc.encode.item_id_column]))
    hfeat = feats.categorical_history_features[0]
    skus_sorted = sorted(skus)
    hashed = hash_strings_to_long(skus_sorted, hash_feature_name_to_int(hfeat.history_id_feature_name),
                                  value_to_lower=False)
    item_embs = encode_catalog(wrapper, np.asarray(hashed, np.int64))
    item_table = {s: item_embs[i] for i, s in enumerate(skus_sorted)}
    logger.info("joint encode: %d users, %d skus", len(user_table), len(item_table))
    return {"users": user_table, "items": item_table}


def _enrich_dataset(jc: JointPipelineConfig, tables, out_root: str, zero: bool) -> Dict[str, str]:
    """Rewrite every ranking parquet with the user_emb and item_emb columns
    (zeroed for the ablation arm); returns the new train and val globs."""
    from recommendations_tpu_torch.data.data_store import DataStoreAccessor
    from recommendations_tpu_torch.data.paths import get_val_data_paths
    from recommendations_tpu_torch.features.transforms import objects
    from recommendations_tpu_torch.tools.synth_data import write_parquet_table

    store = DataStoreAccessor.get_instance(jc.ranking.dataset.filesystem_config)
    zero_vec = np.zeros(jc.retrieval.model.product_tower.product_emb_dim, np.float32)
    users, items = tables["users"], tables["items"]
    ucol, icol = jc.encode.user_id_column, jc.encode.item_id_column
    uout, iout = jc.encode.user_emb_column, jc.encode.item_emb_column
    val_set = set(get_val_data_paths(jc.ranking.dataset) or [])

    shutil.rmtree(out_root, ignore_errors=True)
    coverage_n = coverage_hit = 0
    for path in _ranking_paths(jc.ranking):
        table = store.read_single_parquet_file(path)
        n = len(table[ucol])
        if zero:
            table[uout] = objects([zero_vec] * n)
            table[iout] = objects([zero_vec] * n)
        else:
            table[uout] = objects(users.get(str(u), zero_vec) for u in table[ucol])
            table[iout] = objects(items.get(str(p), zero_vec) for p in table[icol])
            coverage_n += n
            coverage_hit += int(sum(np.abs(v).sum() > 0 for v in table[uout]))
        # the date partition kept under the new root; routed by membership
        # of the validation paths (a train directory named 'val' stays train)
        parts = path.replace("\\", "/").split("/")
        date_part = next((p for p in parts if p.startswith("date=")), "date=20240101")
        sub = "val" if path in val_set else "train"
        dst_dir = os.path.join(out_root, sub, date_part)
        os.makedirs(dst_dir, exist_ok=True)
        write_parquet_table(table, os.path.join(dst_dir, parts[-1]))
    if not zero and coverage_n:
        cov = coverage_hit / coverage_n
        logger.info("join coverage: %.3f", cov)
        if cov < 0.5:
            logger.warning("joint enrich: <50%% of impressions matched a user vector - check id columns (%s)", ucol)
    return {
        "train_glob": os.path.join(out_root, "train", "*", "*.parquet"),
        "val_glob": os.path.join(out_root, "val", "*", "*.parquet"),
    }


class JointTrainerPipeline:
    """Two ``TrainerPipeline`` runs with the encode and enrich stages
    between them, on ``device``."""

    def __init__(self, config: JointPipelineConfig, device="cuda"):
        self.config = config
        self.device = device

    def _assemble(self, cfg: TrainerPipelineConfig):
        from recommendations_tpu_torch.main_training import build_pipeline

        return build_pipeline(cfg, self.device)

    def execute(self) -> Dict[str, Any]:
        jc = self.config
        if jc.synth.enabled:
            _generate_synth(jc)

        # 1. the retrieval stage
        retr = self._assemble(jc.retrieval)
        retr_metrics = retr.execute()
        wrapper, state = retr._trained
        if state is None:
            raise RuntimeError("retrieval stage produced no trained state")

        # 2. encode users and items
        tables = _encode_tables(jc, wrapper)

        # 3-4. enrich, and the ranking stage(s)
        def run_ranking(zero: bool, tag: str) -> Dict[str, Any]:
            out_root = jc.enriched_dir + ("_ablated" if zero else "")
            globs = _enrich_dataset(jc, tables, out_root, zero)
            rk = copy.deepcopy(jc.ranking)
            rk.dataset.path_glob_train = globs["train_glob"]
            rk.dataset.path_glob_test = globs["val_glob"]
            m = self._assemble(rk).execute()
            logger.info("ranking arm %s: %s", tag, {
                k: round(v, 5) for k, v in m.items() if isinstance(v, float) and ("auc" in k or "loss" in k)
            })
            return m

        rank_metrics = run_ranking(False, "with-embeddings")
        out: Dict[str, Any] = {"retrieval": retr_metrics, "ranking": rank_metrics}
        for k, v in rank_metrics.items():
            if isinstance(v, float):
                out[f"joint_{k}"] = v

        # 5. the ablation arm -> the uplift
        if jc.ablation:
            ablated = run_ranking(True, "ablated")
            out["ranking_ablated"] = ablated
            for k, v in rank_metrics.items():
                if k.startswith("val_auc_") and isinstance(v, float) and k in ablated:
                    out[f"auc_uplift_{k[len('val_auc_'):]}"] = v - ablated[k]
        return out
