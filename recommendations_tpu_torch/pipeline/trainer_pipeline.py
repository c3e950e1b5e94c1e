"""The top-level pipeline: trackers -> data paths -> train -> export.

Port of ``recommendations_tpu/pipeline/trainer_pipeline.py`` (reference
``commons/pipeline/trainer_pipeline.py:43-224``): log every config section
as flattened params, resolve the train and validation paths, run the
training strategy, export the final model (and, through the model
checkpointer, at each checkpoint), upload the artifacts. The KNN eval, the
batch inference and the traced export programs are not ported yet (ROADMAP,
port queue item 11): a config that asks for one raises.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import os
import tempfile
from typing import Any, Dict, Optional

from recommendations_tpu_torch.config.base import model_dump
from recommendations_tpu_torch.config.pipeline_config import TrainerPipelineConfig
from recommendations_tpu_torch.data.data_store import DataStoreAccessor
from recommendations_tpu_torch.data.paths import get_train_data_paths, get_val_data_paths
from recommendations_tpu_torch.pipeline.export import export_model_artifacts
from recommendations_tpu_torch.pipeline.model_builder import ModelBuilder
from recommendations_tpu_torch.pipeline.model_checkpointer import ModelCheckpointer

logger = logging.getLogger(__name__)

_ITEM_11 = "ROADMAP, port queue item 11 (Pipeline extras)"


@dataclasses.dataclass
class EvalResult:
    """The metric rows an export writes next to the model (the JAX
    package's data frames; one dict a row here)."""

    result_df: Optional[Dict[str, Any]] = None
    result_extra_day_df: Optional[Dict[str, Any]] = None


def _write_row(metrics: Dict[str, Any], path: str) -> None:
    """One CSV row of the scalar metrics, as the JAX package's
    ``DataFrame.to_csv(index=False)`` of a one-row frame."""
    scalars = {k: v for k, v in metrics.items() if not isinstance(v, (dict, list))}
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(scalars)
        w.writerow(scalars.values())


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

    def _refuse_unported(self) -> None:
        cfg = self.pipeline_config
        if cfg.export is not None and cfg.export.trace:
            raise NotImplementedError(f"traced export programs (export.trace) are not ported yet: {_ITEM_11}")
        if cfg.eval is not None and not cfg.eval.skip_eval:
            raise NotImplementedError(f"the KNN eval (eval.skip_eval: false) is not ported yet: {_ITEM_11}")
        if cfg.inference is not None and not cfg.inference.skip_inference:
            raise NotImplementedError(
                f"batch inference (inference.skip_inference: false) is not ported yet: {_ITEM_11}"
            )
        if cfg.train.skip_train:
            raise NotImplementedError(f"skip_train serves only eval and inference, which are not ported yet: {_ITEM_11}")

    def execute(self) -> Dict[str, Any]:
        self._refuse_unported()
        cfg = self.pipeline_config
        trackers = cfg.trackers
        trackers.start_run()
        for section in ("dataset", "train", "inference", "eval", "export", "training_strategy", "data_loader"):
            obj = getattr(cfg, section, None)
            if obj is not None:
                trackers.log_params_flatten(section, model_dump(obj))
        trackers.log_params({"model_version": cfg.model_version})

        train_paths = get_train_data_paths(cfg.dataset)
        val_paths = get_val_data_paths(cfg.dataset)
        logger.info("train paths: %d, val paths: %d", len(train_paths), len(val_paths))

        wrapper, state, metrics = self.training_strategy.train(
            self.model_builder,
            self.data_loader_strategy,
            train_paths,
            val_paths,
            cfg,
            self.model_checkpointer,
        )
        self._trained = (wrapper, state)
        self.export_model(state=state, eval_result=None, training_done=True)
        trackers.end_run()
        return metrics

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
            if state is not None:
                export_model_artifacts(state.wrapper, tmp, export_config_str=cfg.export.export_config_str)
            store.upload_dir_recursive(local_directory=tmp, folder=f"{cfg.export.path_prefix}/{cfg.model_version}")
            cfg.trackers.log_artifacts(tmp)
