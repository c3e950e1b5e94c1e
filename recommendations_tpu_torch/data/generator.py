"""Streaming dataset generator: path chunks -> parquet -> feature transforms.

Port of ``recommendations_tpu/data/generator.py`` (reference
``commons/data/simple_dataset_generator.py``): iterate the path chunks, read
each file (a pool of ``max_readers`` threads), apply the per-kind data
mapper, concatenate the chunk and, with ``shuffle_data``, shuffle its rows
with the chunk's own seed; reader sharding by ``chunk_index % num_shards``.

The row shuffle is the JAX package's ``df.sample(frac=1.0,
random_state=seed + chunk_index)``: pandas draws
``RandomState(seed).choice(n, n, replace=False)``, which is
``RandomState(seed).permutation(n)`` (held by tests/test_torch_data.py).
The JAX package's O(1) resume helpers (``set_skip_rows``,
``set_start_chunk``) and its reader sharding (``set_shard``, which nothing
calls there) are not ported; the trainer replays batches instead.
"""

from __future__ import annotations

import abc
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional

import numpy as np

from recommendations_tpu_torch.config.trainer_config import DataLoaderConfig, FileSystemConfig
from recommendations_tpu_torch.data.data_store import DataStoreAccessor
from recommendations_tpu_torch.data.paths import get_path_chunks
from recommendations_tpu_torch.features.transforms import Table, concat_tables, num_rows, take_rows

logger = logging.getLogger(__name__)

# data-mapper factory: kind ('train' | 'val') -> (table -> table)
TableMapperFnForKind = Callable[[str], Callable[[Table], Table]]


def shuffle_rows(table: Table, rs: np.random.RandomState) -> Table:
    """The rows of ``table`` in the order ``rs.permutation(n)``: pandas'
    ``sample(frac=1.0, random_state=rs)``."""
    return take_rows(table, rs.permutation(num_rows(table)))


class SimpleDatasetGenerator:
    def __init__(
        self,
        kind: str,
        worker_id: int,
        paths: List[str],
        block_size: int,
        columns: List[str],
        data_mapper: TableMapperFnForKind,
        fs_config: FileSystemConfig,
        shuffle_files: bool = True,
        shuffle_data: bool = False,
        seed: Optional[int] = None,
        max_readers: int = 1,
    ):
        self.kind = kind
        self.max_readers = max_readers
        self.columns = columns
        self.data_mapper = data_mapper
        self.fs_config = fs_config
        self.shuffle_data = shuffle_data
        self.path_chunks = get_path_chunks(paths, block_size, shuffle_files, seed)
        self._seed = seed

    def _read_one(self, store, mapper, path) -> Optional[Table]:
        table = store.read_single_parquet_file(path, columns=self.columns)
        if table is None:
            return None
        try:
            return mapper(table)
        except Exception:
            logger.exception("data mapper failed on %s", path)
            return None

    def __iter__(self) -> Iterator[Table]:
        mapper = self.data_mapper(self.kind)
        store = DataStoreAccessor.get_instance(self.fs_config)
        pool = ThreadPoolExecutor(max_workers=self.max_readers) if self.max_readers > 1 else None
        try:
            for chunk_idx, chunk in enumerate(self.path_chunks):
                if pool is not None:
                    tables = list(pool.map(lambda p: self._read_one(store, mapper, p), chunk))
                else:
                    tables = [self._read_one(store, mapper, p) for p in chunk]
                tables = [t for t in tables if t is not None]
                if not tables:
                    continue
                table = concat_tables(tables)
                if self.shuffle_data:
                    # per-chunk seed: one seed for all would shuffle every
                    # chunk with the same permutation
                    seed = None if self._seed is None else self._seed + chunk_idx
                    table = shuffle_rows(table, np.random.RandomState(seed))
                yield table
        finally:
            if pool is not None:
                pool.shutdown(wait=True)


class DataLoaderStrategy(abc.ABC):
    def __init__(self, data_loader_config: DataLoaderConfig, columns: List[str], data_mapper: TableMapperFnForKind):
        self.data_loader_config = data_loader_config
        self.columns = columns
        self.data_mapper = data_mapper

    @abc.abstractmethod
    def load(
        self, kind: str, worker_id: int, paths: List[str], fs_config: FileSystemConfig, seed: Optional[int] = None
    ) -> SimpleDatasetGenerator:
        ...


class SimpleDataLoaderStrategy(DataLoaderStrategy):
    def load(self, kind, worker_id, paths, fs_config, seed=None):
        return SimpleDatasetGenerator(
            kind=kind,
            worker_id=worker_id,
            paths=paths,
            block_size=self.data_loader_config.block_size,
            columns=self.columns,
            data_mapper=self.data_mapper,
            fs_config=fs_config,
            shuffle_files=self.data_loader_config.shuffle_files,
            shuffle_data=self.data_loader_config.shuffle_data,
            seed=seed,
            max_readers=self.data_loader_config.max_readers,
        )


def get_data_loader_strategy(
    data_loader_config: DataLoaderConfig, columns: List[str], data_mapper: TableMapperFnForKind
) -> DataLoaderStrategy:
    return SimpleDataLoaderStrategy(data_loader_config, columns, data_mapper)
