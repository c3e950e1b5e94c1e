"""The top-level pipeline: trackers -> data paths -> train -> export -> eval
-> inference.

Port of ``recommendations_tpu/pipeline/trainer_pipeline.py`` (reference
``commons/pipeline/trainer_pipeline.py:43-224``): log every config section
as flattened params, resolve the train and validation paths, capture the
trace batch for the exported programs (``export.trace``), run the training
strategy (or, with ``skip_train``, build the untrained wrapper), export the
final model (and, through the model checkpointer, at each checkpoint), run
the KNN eval (``knn_eval.csv`` in the export) and the batch inference
(uploaded under ``<path_prefix>/<model_version>/inference``).
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
import tempfile
from typing import Any, Dict, List, Optional

import torch.distributed as dist

from recommendations_tpu_torch.config.base import model_dump
from recommendations_tpu_torch.config.pipeline_config import TrainerPipelineConfig
from recommendations_tpu_torch.data.data_store import DataStoreAccessor
from recommendations_tpu_torch.data.paths import get_train_data_paths, get_val_data_paths
from recommendations_tpu_torch.pipeline.export import export_model_artifacts
from recommendations_tpu_torch.pipeline.model_builder import ModelBuilder
from recommendations_tpu_torch.pipeline.model_checkpointer import ModelCheckpointer

logger = logging.getLogger(__name__)

@dataclasses.dataclass
class EvalResult:
    """The metric rows an export writes next to the model (the JAX
    package's data frames; one dict a row here)."""

    result_df: Optional[Dict[str, Any]] = None
    result_extra_day_df: Optional[Dict[str, Any]] = None
    knn_eval_result: Optional[List[Dict[str, Any]]] = None


def _write_rows(rows: List[Dict[str, Any]], path: str) -> None:
    """The rows as CSV, a header of their keys, as ``DataFrame.to_csv(index=False)``."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(rows[0])
        for row in rows:
            w.writerow(row.values())


def _write_row(metrics: Dict[str, Any], path: str) -> None:
    """One CSV row of the scalar metrics, as the JAX package's
    ``DataFrame.to_csv(index=False)`` of a one-row frame."""
    _write_rows([{k: v for k, v in metrics.items() if not isinstance(v, (dict, list))}], path)


class TrainerPipeline:
    def __init__(
        self,
        pipeline_config: TrainerPipelineConfig,
        model_builder: ModelBuilder,
        training_strategy,
        data_loader_strategy,
    ):
        self.pipeline_config = pipeline_config
        self.model_builder = model_builder
        self.training_strategy = training_strategy
        self.data_loader_strategy = data_loader_strategy
        self.model_checkpointer = ModelCheckpointer(
            lambda state, result_df=None, result_extra_day_df=None: self.export_model(
                state=state,
                eval_result=EvalResult(result_df=result_df, result_extra_day_df=result_extra_day_df),
                training_done=False,
            )
        )
        self._trained = None  # (wrapper, state)
        self._trace_batch = None  # the example the exported programs are traced on

    def execute(self) -> Dict[str, Any]:
        """Over several ranks every rank trains; rank 0 alone runs the
        trackers, the export, the evaluation and the inference (on the
        trained model's one-device module)."""
        cfg = self.pipeline_config
        trackers = cfg.trackers
        rank0 = not dist.is_initialized() or dist.get_rank() == 0
        if rank0:
            trackers.start_run()
            for section in ("dataset", "train", "inference", "eval", "export", "training_strategy", "data_loader"):
                obj = getattr(cfg, section, None)
                if obj is not None:
                    trackers.log_params_flatten(section, model_dump(obj))
            trackers.log_params({"model_version": cfg.model_version})

        train_paths = get_train_data_paths(cfg.dataset)
        val_paths = get_val_data_paths(cfg.dataset)
        logger.info("train paths: %d, val paths: %d", len(train_paths), len(val_paths))

        if cfg.export is not None and cfg.export.trace:
            self._capture_trace_batch(train_paths)

        metrics: Dict[str, Any] = {}
        if not cfg.train.skip_train:
            wrapper, state, metrics = self.training_strategy.train(
                self.model_builder,
                self.data_loader_strategy,
                train_paths,
                val_paths,
                cfg,
                self.model_checkpointer,
            )
            self._trained = (wrapper, state)
            if not rank0:
                return metrics
            self.export_model(state=state, eval_result=None, training_done=True)
        else:
            logger.info("skip_train: building untrained model")
            self._trained = (self.model_builder.build(), None)
            if not rank0:
                return metrics

        if cfg.eval is not None and not cfg.eval.skip_eval:
            eval_result = self.eval_model()
            self.export_model(state=None, eval_result=eval_result, training_done=True)

        if cfg.inference is not None and not cfg.inference.skip_inference:
            self.run_inference()

        trackers.end_run()
        return metrics

    def _capture_trace_batch(self, train_paths: List[str]) -> None:
        """The first batch (at most 32 rows) of the train paths, for tracing
        the exported programs; the loader kind is ``val`` (no shuffle buffer,
        a fixed order) and its batch ``data_loader.mini_batch_size``."""
        try:
            from recommendations_tpu_torch.data.loader import get_host_dataloader

            cfg = self.pipeline_config
            loader = get_host_dataloader(
                kind="val",
                worker_id=0,
                paths=train_paths,
                batch_size=cfg.data_loader.mini_batch_size,
                num_steps=1,
                data_loader_strategy=self.data_loader_strategy,
                features_config=cfg.model.features,
                fs_config=cfg.dataset.filesystem_config,
            )
            batch = next(iter(loader), None)
            if batch is not None:
                self._trace_batch = {k: v[:32] for k, v in batch.items()}
        except Exception:
            logger.exception("trace-batch capture failed; exporting without")

    def run_inference(self) -> Optional[str]:
        """Batch inference to parquet, uploaded beside the export."""
        if self._trained is None or self._trained[1] is None:
            return None
        from recommendations_tpu_torch.pipeline.inference import run_inference

        wrapper = self._trained[0]
        cfg = self.pipeline_config
        with tempfile.TemporaryDirectory() as tmp:
            path = run_inference(wrapper, cfg, tmp)
            if path and cfg.export is not None:
                store = DataStoreAccessor.get_instance(cfg.export.filesystem_config)
                store.upload_dir_recursive(tmp, f"{cfg.export.path_prefix}/{cfg.model_version}/inference")
            return path

    def eval_model(self) -> Optional[EvalResult]:
        """The offline KNN retrieval eval (the reference configures it and
        leaves ``eval_model`` as ``pass``). A failure is logged, and raised
        only with ``fail_on_eval_error``."""
        if self._trained is None or self._trained[1] is None:
            return None
        try:
            from recommendations_tpu_torch.pipeline.knn_eval import run_knn_eval

            rows = run_knn_eval(self._trained[0], self.pipeline_config)
            return EvalResult(knn_eval_result=rows)
        except Exception:
            logger.exception("knn eval failed")
            ev = self.pipeline_config.eval
            if ev is not None and ev.fail_on_eval_error:
                raise
            return None

    def export_dir(self) -> Optional[str]:
        """Where the export of this run lands in a local store."""
        cfg = self.pipeline_config
        if cfg.export is None or cfg.export.filesystem_config.local_dir_prefix is None:
            return None
        return os.path.join(cfg.export.filesystem_config.local_dir_prefix, cfg.export.path_prefix, cfg.model_version)

    def export_model(self, state, eval_result: Optional[EvalResult], training_done: bool = False) -> None:
        cfg = self.pipeline_config
        if cfg.export is None:
            return
        store = DataStoreAccessor.get_instance(cfg.export.filesystem_config)
        with tempfile.TemporaryDirectory() as tmp:
            if eval_result is not None:
                if eval_result.result_df is not None:
                    _write_row(eval_result.result_df, os.path.join(tmp, "results.csv"))
                if eval_result.result_extra_day_df is not None:
                    _write_row(eval_result.result_extra_day_df, os.path.join(tmp, "results_extra_day.csv"))
                if eval_result.knn_eval_result:
                    _write_rows(eval_result.knn_eval_result, os.path.join(tmp, "knn_eval.csv"))
            if state is not None:
                export_model_artifacts(
                    state.wrapper, tmp, export_config_str=cfg.export.export_config_str,
                    trace_batch=self._trace_batch,
                )
            store.upload_dir_recursive(local_directory=tmp, folder=f"{cfg.export.path_prefix}/{cfg.model_version}")
            cfg.trackers.log_artifacts(tmp)
