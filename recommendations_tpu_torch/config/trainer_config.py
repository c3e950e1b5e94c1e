"""Trainer, dataset, eval, export, inference and data-loader configs.

Port of ``recommendations_tpu/config/trainer_config.py`` (pydantic models
there, dataclasses here), with the same names, defaults and checks. The
reflection fields (``optimizer_clazz``, ``lr_scheduler_clazz`` and their
kwargs) name optax objects, as in the JAX package; ``train/optimizers.py``
maps the names it knows to ``torch.optim`` and a ``LambdaLR`` schedule for
the parameters no model group claims, and raises on any other name.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class FileSystemKind(str, enum.Enum):
    LOCAL = "local"
    DBFS = "dbfs"
    S3 = "s3"
    FAKE = "fake"  # in-memory store for tests


@dataclass
class FileSystemConfig:
    kind: FileSystemKind
    path_template: Optional[str] = None

    # dbfs
    dbfs_base: Optional[str] = None
    # s3
    s3_bucket_path: Optional[str] = None
    # local
    local_dir_prefix: Optional[str] = None
    local_path_template: Optional[str] = None

    def __post_init__(self):
        self.kind = FileSystemKind(self.kind)
        if self.kind == FileSystemKind.DBFS and self.dbfs_base is None:
            raise ValueError("dbfs_base must be specified for DBFS filesystem")
        if self.kind == FileSystemKind.S3 and self.s3_bucket_path is None:
            raise ValueError("s3_bucket_path must be specified for S3 filesystem")
        if self.kind == FileSystemKind.LOCAL and self.local_dir_prefix is None:
            raise ValueError("local_dir_prefix must be specified for local filesystem")


@dataclass
class TrainDatasetConfig:
    filesystem_config: FileSystemConfig
    exclude_dates: List[str] = field(default_factory=list)
    train_data_ratio: float = 1.0
    val_data_ratio: float = 1.0
    extra_day_val_data_ratio: float = 1.0
    train_data_end_date: str = ""
    train_period_in_days: int = 1
    val_data_start_date: str = ""
    val_period_in_days: int = 1
    extra_day_val_data_start_date: Optional[str] = None
    extra_day_val_period_in_days: int = 1
    path_glob_train: str = ""
    path_glob_test: str = ""


@dataclass
class ModelInferenceConfig:
    num_workers: int = 1
    max_num_batches: Optional[int] = None
    skip_inference: bool = False
    inference_batch_size: int = 32


@dataclass
class ModelEvalConfig:
    num_workers: int = 1
    skip_eval: bool = False
    eval_batch_size: int = 32
    predict: bool = False
    compute_feature_importance: bool = False
    feature_importance_steps: int = 1
    max_eval_steps: int = 100
    skip_knn_eval: bool = True
    fail_on_eval_error: bool = False
    knn_top_k_list: List[int] = field(default_factory=lambda: [1, 5, 10, 20, 100, 200])
    knn_max_query_batches_per_worker: Optional[int] = None
    knn_catalog_table_path: Optional[str] = None
    knn_catalog_id_column: Optional[str] = None
    knn_catalog_chunk_rows: int = 1 << 20
    inference_results_path: Optional[str] = None


@dataclass
class ModelExportConfig:
    filesystem_config: FileSystemConfig
    trace: bool = False
    path_prefix: str = "export"
    export_config_str: bool = True
    export_inference_config: bool = False
    export_index_config: bool = False
    export_if_loss_within_factor_of_best_model: Optional[float] = None
    best_model_after_k_steps: Optional[int] = None


@dataclass
class ModelTrainConfig:
    num_workers: int = 1  # hosts
    use_gpu: bool = False  # kept for the config's shape; the device comes from the entry point
    batch_size: int = 32  # per-host macro batch
    train_steps: int = 1000
    validation_steps: int = 0
    epochs: int = 1
    learning_rate: float = 0.001
    train_metrics_every_n_steps: int = 10
    val_metrics_every_n_steps: int = 100
    gradient_clip_norm: Optional[float] = None
    gradient_clip_value: Optional[float] = None
    sparse_learning_rate: float = 0.25
    weight_decay: Optional[float] = None
    optimizer_clazz: Optional[str] = None  # e.g. "optax.adamw"
    optimizer_kwargs: Optional[Dict[str, Any]] = None
    lr_scheduler_clazz: Optional[str] = None  # e.g. "optax.cosine_decay_schedule"
    lr_scheduler_kwargs: Optional[Dict[str, Any]] = None
    lr_scheduler_step_size: int = 100
    gradient_accumulation_steps: Optional[int] = None
    steps_per_dispatch: int = 1
    skip_train: bool = False
    checkpoint_every_k_steps: Optional[int] = None
    cache_every_k_val_batch: int = 40
    distributed_process_group_timeout_s: int = 1800


class DataLoaderKind(str, enum.Enum):
    SIMPLE = "simple"


@dataclass
class DataLoaderConfig:
    kind: DataLoaderKind = DataLoaderKind.SIMPLE
    block_size: int = 1
    max_prefetch: int = 2
    max_readers: int = 1
    shuffle_files: bool = True
    shuffle_data: bool = False
    mini_batch_size: int = 32
    shuffle_buffer_num_mini_batches: int = 0
    macro_batches_multiples: int = 1
    pin_memory: bool = False  # the device copy always goes through pinned memory
    bypass_dataloader: bool = False
    process_reader: bool = False  # the batcher in a spawned child process (data/loader.py)
