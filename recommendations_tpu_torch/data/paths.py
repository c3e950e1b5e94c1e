"""Dataset paths: date ranges through the data store, glob overrides,
excluded dates and block chunks.

Port of ``recommendations_tpu/data/paths.py`` (reference
``commons/data/dataset_generator_utils.py``): the per-node split of the
files (``get_paths_for_worker``; a node is a JAX host, each reading its
own files), the date ranges, the chunks, and the extra-day validation set
(``get_val_data_paths(..., for_extra_day=True)``).
"""

from __future__ import annotations

import glob
from typing import List, Optional

import numpy as np

from recommendations_tpu_torch.config.trainer_config import TrainDatasetConfig
from recommendations_tpu_torch.data.data_store import DataStoreAccessor, get_date_range_str


def get_paths_for_worker(
    worker_id: int, data_paths: List[str], num_workers: int, seed: Optional[int] = None
) -> List[str]:
    """Contiguous split with the remainder to the first workers."""
    data_paths = sorted(data_paths)
    if seed is not None:
        rng = np.random.RandomState(seed)
        data_paths = list(np.array(data_paths)[rng.permutation(len(data_paths))])
    total = len(data_paths)
    per, rem = total // num_workers, total % num_workers
    count = per + (1 if rem > worker_id else 0)
    start = worker_id * per + min(rem, worker_id)
    return data_paths[start:min(total, start + count)]


def get_path_chunks(
    paths: List[str], block_size: int, shuffle_files: bool = False, seed: Optional[int] = None
) -> List[List[str]]:
    arr = np.array(paths)
    if shuffle_files:
        rng = np.random.RandomState(seed)
        rng.shuffle(arr)
    num_segments = max(1, len(arr) // block_size)
    return [list(p) for p in np.array_split(arr, num_segments)]


def _resolve_dates(date: str, steps: int, backward: bool, exclude: List[str]) -> List[str]:
    dates = get_date_range_str(date=date, steps=steps, backward=backward)
    if exclude:
        dates = [d for d in dates if d not in exclude]
    if not dates:
        raise ValueError("date range is empty after exclusions")
    return dates


def get_train_data_paths(dataset_config: TrainDatasetConfig) -> List[str]:
    if dataset_config.path_glob_train:
        return sorted(glob.glob(dataset_config.path_glob_train))
    dates = _resolve_dates(
        dataset_config.train_data_end_date,
        dataset_config.train_period_in_days,
        backward=True,
        exclude=dataset_config.exclude_dates,
    )
    store = DataStoreAccessor.get_instance(dataset_config.filesystem_config)
    return store.get_training_data_paths_for_dates(dates, dataset_config.train_data_ratio)


def get_val_data_paths(dataset_config: TrainDatasetConfig, for_extra_day: bool = False) -> List[str]:
    """The validation files; with ``for_extra_day``, the extra-day set's
    (``extra_day_val_*``), none where it has no start date or no days."""
    if dataset_config.path_glob_test:
        return sorted(glob.glob(dataset_config.path_glob_test))
    if for_extra_day:
        if dataset_config.extra_day_val_data_start_date is None or dataset_config.extra_day_val_period_in_days <= 0:
            return []
        start, days = dataset_config.extra_day_val_data_start_date, dataset_config.extra_day_val_period_in_days
        ratio = dataset_config.extra_day_val_data_ratio
    else:
        start, days = dataset_config.val_data_start_date, dataset_config.val_period_in_days
        ratio = dataset_config.val_data_ratio
    dates = _resolve_dates(start, days, backward=False, exclude=dataset_config.exclude_dates)
    store = DataStoreAccessor.get_instance(dataset_config.filesystem_config)
    return store.get_training_data_paths_for_dates(dates, ratio)
