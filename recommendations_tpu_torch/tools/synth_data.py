"""Synthetic click logs for the LTHM configs and impression logs for the
ranker, with no JAX and no pandas.

Port of ``make_click_log``, ``write_synthetic_dataset``, ``make_ranking_log``,
``write_ranking_dataset`` and the joint pipeline's cluster-match impressions
(``product_clusters``, ``user_cluster_map``, ``make_cluster_ranking_log``)
of ``recommendations_tpu/tools/synth_data.py``:
for a seed, the same rows, value for value, as a table of numpy columns
(``features/transforms.py``) where the JAX package builds a DataFrame.
Users belong to latent taste clusters and browse within a cluster in a ring
order, so the next item is predictable from the history; an impression's
click and conversion depend on the product's latent quality and the user's
affinity to it, so a ranker's AUC can rise above 0.5.

    python -m recommendations_tpu_torch.tools.synth_data --root DIR \\
        --dates 20240101 20240102 --history-len 64

writes ``DIR/date=YYYYMMDD/part-N.parquet`` (needs pyarrow; ``--ranking``
the ranker's impression logs);
``write_synthetic_dataset(..., fake_store=True)`` puts the same tables into
``data.data_store.FakeDataStore`` instead, under ``date=YYYYMMDD/part-N.parquet``;
``write_ranking_dataset`` likewise for the impression logs.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from recommendations_tpu_torch.data.data_store import FakeDataStore
from recommendations_tpu_torch.features.transforms import Table, objects


def make_click_log(
    num_users: int = 1024,
    history_len: int = 32,
    num_products: int = 2000,
    num_clusters: int = 16,
    seed: int = 0,
    structure_seed: int = 777,
    p_in_cluster_jump: float = 0.0,
) -> Table:
    """Columns customer_id, product_id, product_ids (most recent first),
    labels and timestamps (float32, most recent first). The product ->
    cluster structure comes from ``structure_seed``, shared by every file;
    ``seed`` varies the users and the noise."""
    struct = np.random.RandomState(structure_seed)
    cluster_of_product = struct.randint(0, num_clusters, size=num_products)
    products_by_cluster = [np.where(cluster_of_product == c)[0] for c in range(num_clusters)]
    rng = np.random.RandomState(seed)
    cols = {k: [] for k in ("customer_id", "product_id", "product_ids", "labels", "timestamps")}
    base_ts = 1_700_000_000
    for u in range(num_users):
        c = rng.randint(num_clusters)
        pool = products_by_cluster[c]
        if len(pool) < 2:
            pool = np.arange(num_products)
        start = rng.randint(len(pool))
        n = rng.randint(history_len // 2, history_len + 1)
        if p_in_cluster_jump <= 0.0:
            seq = [pool[(start + i) % len(pool)] for i in range(n)]
        else:
            seq = []
            pos = start
            for _ in range(n):
                seq.append(pool[pos % len(pool)])
                if rng.rand() < p_in_cluster_jump:
                    pos = rng.randint(len(pool))
                else:
                    pos += 1
        if rng.rand() < 0.2:  # noise: an occasional click outside the cluster
            seq[rng.randint(n)] = rng.randint(num_products)
        ts0 = base_ts + rng.randint(0, 86400 * 7)
        timestamps = ts0 + np.arange(n) * rng.randint(30, 600)
        labels = rng.randint(0, 4, size=n)
        cols["customer_id"].append(f"user_{u}")
        cols["product_id"].append(f"sku_{seq[-1]}")
        cols["product_ids"].append([f"sku_{p}" for p in seq[::-1]])
        cols["labels"].append(labels[::-1].astype(np.float32))
        cols["timestamps"].append(timestamps[::-1].astype(np.float32))
    return {k: objects(v) for k, v in cols.items()}


def _pad_lists(table: Table, history_len: int) -> Table:
    """labels and timestamps padded to the fixed history length (a tensor
    list feature has an exact declared shape)."""

    def pad(v):
        v = np.asarray(v, dtype=np.float32)[:history_len]
        return np.pad(v, (0, history_len - len(v)))

    table = dict(table)
    for k in ("labels", "timestamps"):
        table[k] = objects(pad(v) for v in table[k])
    return table


def write_parquet_table(table: Table, path: str) -> None:
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("writing parquet needs pyarrow, which is not installed") from e
    pq.write_table(pa.table({k: pa.array(list(v)) for k, v in table.items()}), path)


def write_synthetic_dataset(
    root: Optional[str],
    dates: Optional[List[str]] = None,
    files_per_date: int = 2,
    users_per_file: int = 512,
    history_len: int = 32,
    num_products: int = 2000,
    seed: int = 0,
    num_clusters: int = 16,
    p_in_cluster_jump: float = 0.0,
    fake_store: bool = False,
) -> List[str]:
    """Date-partitioned files ``root/date=YYYYMMDD/part-N.parquet``, or, with
    ``fake_store``, the same tables in ``FakeDataStore`` under
    ``date=YYYYMMDD/part-N.parquet``; returns their paths."""
    paths = []
    i = 0
    for date in dates or ["20240101"]:
        day_dir = f"date={date}" if fake_store else os.path.join(root, f"date={date}")
        if not fake_store:
            os.makedirs(day_dir, exist_ok=True)
        for p in range(files_per_date):
            table = make_click_log(
                num_users=users_per_file,
                history_len=history_len,
                num_products=num_products,
                num_clusters=num_clusters,
                seed=seed + i,
                p_in_cluster_jump=p_in_cluster_jump,
            )
            table = _pad_lists(table, history_len)
            path = f"{day_dir}/part-{p:05d}.parquet"
            if fake_store:
                FakeDataStore.put_table(path, table)
            else:
                write_parquet_table(table, path)
            paths.append(path)
            i += 1
    return paths


def make_ranking_log(
    num_rows: int = 4096,
    num_products: int = 500,
    num_users: int = 200,
    seed: int = 0,
    structure_seed: int = 777,
) -> Table:
    """Columns product_id, customer_id, search_query (strings), price,
    position, is_returning_user (float32), event_ts (int64), click and
    conversion (float32). The latent quality, user bias and affinity come
    from ``structure_seed``, shared by every file; ``seed`` draws the rows,
    in the JAX package's order (the queries last, one draw a row)."""
    struct = np.random.RandomState(structure_seed)
    quality = struct.randn(num_products) * 1.2
    user_bias = struct.randn(num_users) * 0.6
    affinity = struct.randn(num_users, 8) @ struct.randn(8, num_products) * 0.15
    rng = np.random.RandomState(seed)
    p_idx = rng.randint(0, num_products, num_rows)
    u_idx = rng.randint(0, num_users, num_rows)
    price = np.abs(rng.randn(num_rows) * 40 + 30).astype(np.float32)
    position = rng.randint(0, 20, num_rows)
    logits = (
        quality[p_idx] + user_bias[u_idx] + affinity[u_idx, p_idx]
        - 0.08 * position - 0.004 * price - 1.0
    )
    click = (rng.rand(num_rows) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    conv = click * (rng.rand(num_rows) < 1 / (1 + np.exp(-(logits - 1.0)))).astype(np.float32)
    ts = 1_700_000_000 + rng.randint(0, 86400 * 7, num_rows)
    queries = [f"query_{rng.randint(50)}" for _ in range(num_rows)]
    return {
        "product_id": objects(f"sku_{p}" for p in p_idx),
        "customer_id": objects(f"user_{u}" for u in u_idx),
        "search_query": objects(queries),
        "price": price,
        "position": position.astype(np.float32),
        "is_returning_user": (u_idx % 3 == 0).astype(np.float32),
        "event_ts": ts.astype(np.int64),
        "click": click,
        "conversion": conv,
    }


def write_ranking_dataset(
    root: Optional[str],
    dates: Optional[List[str]] = None,
    files_per_date: int = 2,
    rows_per_file: int = 4096,
    seed: int = 0,
    fake_store: bool = False,
) -> List[str]:
    """Date-partitioned impression logs ``root/date=YYYYMMDD/part-N.parquet``,
    or, with ``fake_store``, the same tables in ``FakeDataStore``; returns
    their paths."""
    paths = []
    i = 0
    for date in dates or ["20240101"]:
        day_dir = f"date={date}" if fake_store else os.path.join(root, f"date={date}")
        if not fake_store:
            os.makedirs(day_dir, exist_ok=True)
        for p in range(files_per_date):
            table = make_ranking_log(num_rows=rows_per_file, seed=seed + i)
            path = f"{day_dir}/part-{p:05d}.parquet"
            if fake_store:
                FakeDataStore.put_table(path, table)
            else:
                write_parquet_table(table, path)
            paths.append(path)
            i += 1
    return paths


def product_clusters(num_products: int, num_clusters: int, structure_seed: int = 777) -> np.ndarray:
    """The synthetic catalog's fixed product -> cluster map (make_click_log's
    structure seed, so both logs share the catalog)."""
    struct = np.random.RandomState(structure_seed)
    return struct.randint(0, num_clusters, size=num_products)


def user_cluster_map(click_table: Table, num_products: int, num_clusters: int) -> dict:
    """user -> the majority cluster of the history (the generator's latent
    draw: histories are about 97% in-cluster)."""
    cop = product_clusters(num_products, num_clusters)
    out = {}
    for uid, history in zip(click_table["customer_id"], click_table["product_ids"]):
        pids = [int(p.split("_")[1]) for p in history if p]
        if pids:
            out[uid] = int(np.bincount(cop[pids], minlength=num_clusters).argmax())
    return out


def make_cluster_ranking_log(user_cluster: dict, users: list, num_products: int, num_clusters: int,
                             num_rows: int, seed: int = 0, match_coef: float = 4.0):
    """Impressions whose click depends on whether the user's cluster is the
    product's: quality and price are learnable without the user signal, the
    match only through the retrieval encoder's embeddings. Returns (table,
    refs), refs the Bayes and product-only logits."""
    cop = product_clusters(num_products, num_clusters)
    quality = np.random.RandomState(778).randn(num_products) * 0.8
    rng = np.random.RandomState(seed)
    u_idx = rng.randint(0, len(users), num_rows)
    p_idx = rng.randint(0, num_products, num_rows)
    u_cl = np.array([user_cluster[users[u]] for u in u_idx])
    match = (u_cl == cop[p_idx]).astype(np.float32)
    price = np.abs(rng.randn(num_rows) * 40 + 30).astype(np.float32)
    logits = quality[p_idx] + match_coef * match - 0.004 * price - 1.8
    click = (rng.rand(num_rows) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    table = {
        "product_id": objects(f"sku_{p}" for p in p_idx),
        "customer_id": objects(users[u] for u in u_idx),
        "price": price,
        "click": click,
    }
    refs = {"true_logit": logits, "product_only_logit": quality[p_idx] - 0.004 * price}
    return table, refs


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--dates", nargs="*", default=["20240101"])
    ap.add_argument("--files-per-date", type=int, default=2)
    ap.add_argument("--users-per-file", type=int, default=512)
    ap.add_argument("--history-len", type=int, default=32)
    ap.add_argument("--num-products", type=int, default=2000)
    ap.add_argument("--ranking", action="store_true", help="the ranker's impression logs (4096 rows a file)")
    args = ap.parse_args()
    if args.ranking:
        out = write_ranking_dataset(args.root, args.dates, args.files_per_date)
    else:
        out = write_synthetic_dataset(
            args.root, args.dates, args.files_per_date, args.users_per_file, args.history_len, args.num_products,
        )
    print(f"wrote {len(out)} files under {args.root}")
