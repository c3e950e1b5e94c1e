"""Batch inference: the validation stream through the model's inference entry
points, to one parquet file.

Port of ``recommendations_tpu/pipeline/inference.py``: for LTHM the
per-user retrieval vectors a vector index ingests, for the ranker the
per-impression task scores. The stream keeps its last partial batch
(``drop_remainder=False``) and drops the rows the batcher padded it with
(``_pad_mask``). Outputs that are per-row scalars or vectors are kept (a
full-sequence tensor is not), with the passthrough columns beside them, and
written with ``pyarrow`` (no pandas), imported in the thread that writes.
The wrapper holds the weights it serves.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _host(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def _arrow_column(parts: List[np.ndarray]):
    """One parquet column from the kept rows of each batch: a primitive
    column of per-row scalars, a list column of per-row vectors (strings
    and other objects as they are)."""
    import pyarrow as pa

    values = np.concatenate(parts, axis=0)
    if values.ndim == 1:
        return pa.array(values if values.dtype != object else list(values))
    offsets = np.arange(0, values.size + 1, values.shape[1], dtype=np.int32)
    return pa.ListArray.from_arrays(pa.array(offsets), pa.array(values.reshape(-1)))


def run_inference(wrapper, pipeline_config, output_dir: str) -> Optional[str]:
    cfg = pipeline_config
    if cfg.inference is None or cfg.inference.skip_inference:
        return None
    from recommendations_tpu_torch.data.generator import get_data_loader_strategy
    from recommendations_tpu_torch.data.loader import get_host_dataloader
    from recommendations_tpu_torch.data.paths import get_val_data_paths

    feats = cfg.model.features
    strategy = get_data_loader_strategy(
        cfg.data_loader, feats.get_input_columns(), lambda kind: feats.default_data_mapper,
    )
    paths = get_val_data_paths(cfg.dataset)
    if not paths:
        logger.info("no inference paths")
        return None
    loader = get_host_dataloader(
        kind="val", worker_id=0, paths=paths,
        batch_size=cfg.inference.inference_batch_size,
        num_steps=cfg.inference.max_num_batches,
        data_loader_strategy=strategy, features_config=feats,
        fs_config=cfg.dataset.filesystem_config,
        drop_remainder=False,
    )
    entries = wrapper.inference_models()
    # passthrough columns for joining results downstream
    passthrough = [f.name for f in feats._all_features() if f.include_in_eval_output] or [
        f.name for f in feats._all_features() if f.do_not_convert_to_platform_type
    ]

    columns: Dict[str, List[np.ndarray]] = {}
    for batch in loader:
        pad_mask = batch.get("_pad_mask")
        inputs = {
            k: v for k, v in batch.items()
            if getattr(v, "dtype", None) is not None and v.dtype.kind in "ifub" and k != "_pad_mask"
        }
        n = len(next(iter(batch.values())))
        keep = ~np.asarray(pad_mask) if pad_mask is not None else np.ones(n, bool)
        record: Dict[str, np.ndarray] = {}
        for name, fn in entries.items():
            out = fn(inputs)
            # in key order, as JAX's jitted entry points return their dicts
            outs = sorted(out.items()) if isinstance(out, dict) else [(None, out)]
            for k, v in outs:
                arr = _host(v)
                # keep per-row scalars and vectors; skip full-sequence tensors
                if arr.shape[:1] == (n,) and arr.ndim <= 2:
                    record[name if k is None else f"{name}.{k}"] = arr[keep]
        for col in passthrough:
            if col in batch:
                record[col] = np.asarray(batch[col])[keep]
        for k, v in record.items():
            columns.setdefault(k, []).append(v)

    if not columns:
        return None
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, "inference_results.parquet")
    table = pa.table({k: _arrow_column(parts) for k, parts in columns.items()})
    pq.write_table(table, out_path)
    logger.info("wrote %d inference rows to %s", table.num_rows, out_path)
    return out_path
