"""Storage: one interface over the local file system, S3 and an in-memory
store.

Port of ``recommendations_tpu/data/data_store.py``: list a date range's data
files, read one parquet file into a table of numpy columns
(``features/transforms.py``), read a file's bytes, upload artifacts.
``LocalDataStore`` reads parquet through ``pyarrow``, imported by the
reader only; ``S3DataStore`` through ``boto3`` (imported when the store is
made; without it the store raises ``ImportError``), every request retried
with a doubling backoff; ``FakeDataStore`` holds numpy tables in memory
(the JAX package's ``FileSystemKind.FAKE``).
"""

from __future__ import annotations

import abc
import datetime
import glob
import io
import logging
import os
import random
import shutil
import time
from typing import Dict, List, Optional

import numpy as np

from recommendations_tpu_torch.config.trainer_config import FileSystemConfig, FileSystemKind
from recommendations_tpu_torch.features.transforms import Table, num_rows

logger = logging.getLogger(__name__)


def get_date_range_str(date: str, steps: int, backward: bool) -> List[str]:
    """``steps`` dates ending (backward) or starting (forward) at ``date``
    (YYYYMMDD) - reference ``data_store.py:25-37``."""
    d = datetime.datetime.strptime(date, "%Y%m%d")
    sign = -1 if backward else 1
    return [(d + sign * datetime.timedelta(days=i)).strftime("%Y%m%d") for i in range(steps)]


def sample_paths(paths: List[str], data_ratio: float, seed: Optional[int] = 17) -> List[str]:
    if data_ratio >= 1.0:
        return paths
    rng = random.Random(seed)
    k = max(1, int(len(paths) * data_ratio))
    return sorted(rng.sample(paths, k))


def read_parquet_table(source, columns: Optional[List[str]] = None) -> Table:
    """A parquet file (a path or a file object) as numpy columns: list and
    string columns become object arrays, as pandas reads them. The file's own
    columns only: no partition column is read from a ``date=...`` directory
    (some pyarrow versions add one, which a file written back there then
    holds twice, and cannot be read)."""
    try:
        import pyarrow.parquet as pq
    except ImportError as e:
        raise ImportError("reading parquet needs pyarrow, which is not installed") from e
    table = pq.read_table(source, columns=columns, partitioning=None)
    names = columns if columns is not None else table.column_names
    return {name: table.column(name).combine_chunks().to_numpy(zero_copy_only=False) for name in names}


class DataStoreInterface(abc.ABC):
    @abc.abstractmethod
    def get_training_data_paths_for_dates(self, data_dates: List[str], data_ratio: float = 1.0) -> List[str]:
        ...

    @abc.abstractmethod
    def read_single_parquet_file(self, path: str, columns: Optional[List[str]] = None) -> Optional[Table]:
        ...

    @abc.abstractmethod
    def get_file_from_path(self, path: str) -> bytes:
        ...

    @abc.abstractmethod
    def upload_dir_recursive(self, local_directory: str, folder: str) -> None:
        ...

    def parquet_num_rows(self, path: str) -> Optional[int]:
        """A file's row count from its metadata, without reading its data,
        or None where the store cannot tell cheaply."""
        return None

    @staticmethod
    def _is_data_file(name: str) -> bool:
        base = os.path.basename(name)
        return not (base.startswith("_") or base.startswith(".") or base == "" or base.endswith(".crc"))


class LocalDataStore(DataStoreInterface):
    """The local file system; also DBFS through its /dbfs mount."""

    def __init__(self, config: FileSystemConfig):
        self.config = config
        if config.kind == FileSystemKind.DBFS:
            self.base = config.dbfs_base.replace("dbfs:/", "/dbfs/")
        else:
            self.base = config.local_dir_prefix or "."
        # the parquet reader is imported here, in the thread that makes the
        # store: first imported in a reader thread that then exits, pyarrow
        # (25.0.0) crashes the next thread that reads a file
        try:
            import pyarrow.parquet  # noqa: F401
        except ImportError:
            pass

    def _date_dir(self, date: str) -> str:
        template = self.config.path_template or "date={date}"
        return os.path.join(self.base, template.format(date=date))

    def get_training_data_paths_for_dates(self, data_dates, data_ratio=1.0):
        paths: List[str] = []
        for date in data_dates:
            found = sorted(glob.glob(os.path.join(self._date_dir(date), "**", "*"), recursive=True))
            paths.extend(p for p in found if os.path.isfile(p) and self._is_data_file(p))
        return sample_paths(paths, data_ratio)

    def read_single_parquet_file(self, path, columns=None):
        try:
            return read_parquet_table(path, columns)
        except ImportError:
            raise
        except Exception:
            logger.exception("failed reading %s", path)
            return None

    def parquet_num_rows(self, path):
        try:
            import pyarrow.parquet as pq

            return int(pq.read_metadata(path).num_rows)
        except Exception:
            return None

    def get_file_from_path(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def upload_dir_recursive(self, local_directory: str, folder: str) -> None:
        target = os.path.join(self.base, folder)
        os.makedirs(target, exist_ok=True)
        for root, _, files in os.walk(local_directory):
            for name in files:
                src = os.path.join(root, name)
                dst = os.path.join(target, os.path.relpath(src, local_directory))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(src, dst)


class FakeDataStore(DataStoreInterface):
    """In-memory store of numpy tables, keyed by path; the tables and files
    are the class's, shared by every instance (``reset`` clears them)."""

    _tables: Dict[str, Table] = {}
    _files: Dict[str, bytes] = {}

    def __init__(self, config: Optional[FileSystemConfig] = None):
        self.config = config

    @classmethod
    def reset(cls):
        cls._tables.clear()
        cls._files.clear()

    @classmethod
    def put_table(cls, path: str, table: Table):
        cls._tables[path] = table

    def get_training_data_paths_for_dates(self, data_dates, data_ratio=1.0):
        template = (self.config.path_template if self.config else None) or "date={date}"
        out = []
        for date in data_dates:
            prefix = template.format(date=date)
            out.extend(sorted(p for p in self._tables if p.startswith(prefix)))
        return sample_paths(out, data_ratio)

    def read_single_parquet_file(self, path, columns=None):
        table = self._tables.get(path)
        if table is None:
            return None
        return {c: np.array(table[c], copy=True) for c in (columns or table)}

    def parquet_num_rows(self, path):
        table = self._tables.get(path)
        return None if table is None else num_rows(table)

    def get_file_from_path(self, path: str) -> bytes:
        return self._files[path]

    def upload_dir_recursive(self, local_directory: str, folder: str) -> None:
        for root, _, files in os.walk(local_directory):
            for name in files:
                src = os.path.join(root, name)
                with open(src, "rb") as f:
                    self._files[f"{folder}/{os.path.relpath(src, local_directory)}"] = f.read()


class S3DataStore(DataStoreInterface):
    """S3 through ``boto3`` (its resource lists, its client reads and
    uploads), each request retried up to ``max_retries`` times with a
    doubling delay plus up to a second of jitter, the last failure raised.
    Paths are ``s3://<bucket>/<key>``, the keys under the config's
    ``path_template`` of each date."""

    def __init__(self, config: FileSystemConfig, max_retries: int = 5):
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise ImportError("boto3 is required for S3DataStore but is not installed") from e
        self.config = config
        self.bucket_name = config.s3_bucket_path
        self._s3 = boto3.resource("s3")
        self._client = boto3.client("s3")
        self.max_retries = max_retries
        try:  # in the thread that makes the store (see LocalDataStore)
            import pyarrow.parquet  # noqa: F401
        except ImportError:
            pass

    def _retry(self, fn, *args, **kw):
        delay = 1.0
        for attempt in range(self.max_retries):
            try:
                return fn(*args, **kw)
            except Exception:
                if attempt == self.max_retries - 1:
                    raise
                time.sleep(delay + random.random())
                delay *= 2

    def get_training_data_paths_for_dates(self, data_dates, data_ratio=1.0):
        template = self.config.path_template or "date={date}"
        bucket = self._s3.Bucket(self.bucket_name)
        paths: List[str] = []
        for date in data_dates:
            prefix = template.format(date=date)
            objs = self._retry(lambda p=prefix: list(bucket.objects.filter(Prefix=p)))
            paths.extend(f"s3://{self.bucket_name}/{o.key}" for o in objs if self._is_data_file(o.key))
        return sample_paths(sorted(paths), data_ratio)

    def _strip(self, path: str) -> str:
        prefix = f"s3://{self.bucket_name}/"
        return path[len(prefix):] if path.startswith(prefix) else path

    def read_single_parquet_file(self, path, columns=None):
        try:
            return read_parquet_table(io.BytesIO(self.get_file_from_path(path)), columns)
        except ImportError:
            raise
        except Exception:
            logger.exception("failed reading %s", path)
            return None

    def get_file_from_path(self, path: str) -> bytes:
        obj = self._retry(self._client.get_object, Bucket=self.bucket_name, Key=self._strip(path))
        return obj["Body"].read()

    def upload_dir_recursive(self, local_directory: str, folder: str) -> None:
        for root, _, files in os.walk(local_directory):
            for name in files:
                src = os.path.join(root, name)
                key = f"{folder}/{os.path.relpath(src, local_directory)}"
                self._retry(self._client.upload_file, src, self.bucket_name, key)


class DataStoreAccessor:
    """One store per file-system config - reference ``data_store.py:95-102``."""

    _instances: Dict[str, DataStoreInterface] = {}

    @classmethod
    def get_instance(cls, fs_config: FileSystemConfig) -> DataStoreInterface:
        key = repr(fs_config)
        if key not in cls._instances:
            if fs_config.kind == FileSystemKind.S3:
                cls._instances[key] = S3DataStore(fs_config)
            elif fs_config.kind in (FileSystemKind.LOCAL, FileSystemKind.DBFS):
                cls._instances[key] = LocalDataStore(fs_config)
            elif fs_config.kind == FileSystemKind.FAKE:
                cls._instances[key] = FakeDataStore(fs_config)
            else:
                raise ValueError(f"Unsupported filesystem {fs_config.kind}")
        return cls._instances[key]
