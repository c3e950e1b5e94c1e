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

The resume helpers: ``set_skip_rows(n)`` skips the first n rows of the
next iteration, whole chunks by the store's row counts (no read, no
transform) and the chunk holding the cursor by a slice;
``set_start_chunk(n)`` starts the next iteration at chunk n (a snapshot's
cursor). The JAX package's reader sharding (``set_shard``, which nothing
calls there) is not ported.
"""

from __future__ import annotations

import abc
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional

import numpy as np

from recommendations_tpu_torch.config.trainer_config import DataLoaderConfig, FileSystemConfig, FileSystemKind
from recommendations_tpu_torch.data.data_store import DataStoreAccessor, FakeDataStore
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
        self._skip_rows = 0
        self._start_chunk = 0

    def __getstate__(self):
        """The recipe, for a reader in another process; on the in-memory
        store it carries the tables it reads, which another process does
        not share."""
        state = dict(self.__dict__)
        if self.fs_config.kind == FileSystemKind.FAKE:
            tables = FakeDataStore._tables
            state["_fake_tables"] = {p: tables[p] for chunk in self.path_chunks for p in chunk if p in tables}
        return state

    def __setstate__(self, state):
        for path, table in state.pop("_fake_tables", {}).items():
            FakeDataStore.put_table(path, table)
        self.__dict__.update(state)

    def set_skip_rows(self, n: int) -> None:
        """Skip the first ``n`` rows of the next iteration: chunks that lie
        wholly before the cursor by their row counts (assumes the data
        mapper keeps row counts, as every compiled transform does, and a
        seeded generator), the chunk holding it by a slice."""
        self._skip_rows = max(0, int(n))

    def set_start_chunk(self, n: int) -> None:
        """Start the next iteration at chunk ``n`` without reading the
        earlier ones."""
        self._start_chunk = max(0, int(n))

    def _chunk_num_rows(self, store, chunk) -> Optional[int]:
        total = 0
        for p in chunk:
            n = store.parquet_num_rows(p)
            if n is None:
                return None
            total += n
        return total

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
        skip, self._skip_rows = self._skip_rows, 0
        start_chunk, self._start_chunk = self._start_chunk, 0
        try:
            for chunk_idx, chunk in enumerate(self.path_chunks):
                if chunk_idx < start_chunk:
                    continue
                if skip > 0:
                    n = self._chunk_num_rows(store, chunk)
                    if n is not None and skip >= n:
                        skip -= n  # by the row counts: no read, no transform
                        continue
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
                if skip > 0:
                    # the cursor lies inside this chunk (or its row count was unknown)
                    take = min(skip, num_rows(table))
                    table = take_rows(table, slice(take, None))
                    skip -= take
                    if num_rows(table) == 0:
                        continue
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
