"""Host data loader: a prefetching thread of numpy batches, and their copy
onto the run's device.

Port of ``recommendations_tpu/data/loader.py``: ``get_host_dataloader``
(with ``bypass_dataloader``), ``HostDataLoader`` (a bounded background
thread) and ``StageTimer``. The JAX package's ``DevicePrefetcher`` and
``device_put_batch`` become ``DevicePrefetcher`` here: each batch's numpy
columns are copied into pinned host memory and from there, on a side CUDA
stream, onto the card while the step before runs. Each batch's pinned buffers
are held until the event recorded after its copies has completed, so a
pinned buffer is never freed, and so never reused, under an unfinished
copy. Object columns (strings, ids kept on the
host) do not go to the device, as in the JAX package. The forked reader
(``process_reader``) is not ported yet (ROADMAP, port queue item 6b).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from recommendations_tpu_torch.config.trainer_config import DataLoaderConfig, FileSystemConfig
from recommendations_tpu_torch.data.generator import DataLoaderStrategy
from recommendations_tpu_torch.data.grouping import GroupedBatchDataset
from recommendations_tpu_torch.features.feature_config import FeaturesConfig

logger = logging.getLogger(__name__)

_SENTINEL = object()


class StageTimer:
    """Cumulative wall-time counters of the feed path: each stage adds
    (seconds, count), and ``summary`` gives the ms per batch of each, so
    the stage that binds is named by measurement."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, stage: str, seconds: float, n: int = 1) -> None:
        with self._lock:
            self.totals[stage] = self.totals.get(stage, 0.0) + seconds
            self.counts[stage] = self.counts.get(stage, 0) + n

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {}
            for k, s in sorted(self.totals.items()):
                c = max(1, self.counts.get(k, 1))
                out[k] = {"total_s": round(s, 3), "count": self.counts.get(k, 0), "ms_per_batch": round(s / c * 1e3, 3)}
            return out

    def log(self, header: str = "feed-path stage timers") -> None:
        logger.info("%s: %s", header, self.summary())


def _timed_iter(it, timer: Optional[StageTimer], stage: str):
    """``it``'s items, the time of each ``next`` added to ``stage``."""
    it = iter(it)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        if timer is not None:
            timer.add(stage, time.perf_counter() - t0)
        yield item


class HostDataLoader:
    """Fixed-shape numpy batches from a background thread, at most
    ``max_prefetch`` ahead."""

    def __init__(self, dataset: GroupedBatchDataset, max_prefetch: int = 2, timer: Optional[StageTimer] = None):
        self._dataset = dataset
        self._max_prefetch = max(1, max_prefetch)
        self.timer = timer

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=self._max_prefetch)
        err: List[BaseException] = []
        stop = threading.Event()
        timer = self.timer

        def producer():
            try:
                for batch in _timed_iter(self._dataset, timer, "host.produce"):
                    t0 = time.perf_counter()
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if timer is not None:
                        timer.add("host.queue_full_wait", time.perf_counter() - t0)
                    if stop.is_set():
                        return
            except BaseException as e:  # raised again on the consumer's side
                err.append(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                if timer is not None:
                    timer.add("host.consumer_wait", time.perf_counter() - t0)
                if item is _SENTINEL:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # a consumer that stops early (train_steps reached) ends the thread
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's numeric columns as tensors on ``device`` (a blocking
    copy; as they are on the CPU). Object columns stay behind."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items() if v.dtype != object}


class DevicePrefetcher:
    """Host batches -> device batches, ``depth`` ahead: on a card the copies
    run on a side stream while the steps before run, and the step's stream
    waits for a batch's copy before the batch is handed out."""

    def __init__(self, host_iter, device: torch.device, depth: int = 2, timer: Optional[StageTimer] = None):
        self._it = host_iter
        self._device = torch.device(device)
        self._depth = max(1, depth)
        self.timer = timer

    def __iter__(self):
        if self._device.type != "cuda":
            for hb in _timed_iter(self._it, self.timer, "dev.host_iter_wait"):
                yield to_device(hb, self._device)
            return
        stream = torch.cuda.Stream(self._device)
        pending: deque = deque()  # (device batch, its copies' event), not yet handed out
        pinned: deque = deque()  # (event, pinned sources) until the copies have completed

        def ready(item):
            batch, event = item
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)  # the copy stream's memory is now the step's
            while pinned and pinned[0][0].query():
                pinned.popleft()
            return batch

        try:
            for hb in _timed_iter(self._it, self.timer, "dev.host_iter_wait"):
                t0 = time.perf_counter()
                sources = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                           for k, v in hb.items() if v.dtype != object}
                with torch.cuda.stream(stream):
                    batch = {k: t.to(self._device, non_blocking=True) for k, t in sources.items()}
                event = torch.cuda.Event()
                event.record(stream)
                pinned.append((event, sources))
                if self.timer is not None:
                    self.timer.add("dev.device_put", time.perf_counter() - t0)
                pending.append((batch, event))
                if len(pending) > self._depth:
                    yield ready(pending.popleft())
            while pending:
                yield ready(pending.popleft())
        finally:
            stream.synchronize()  # the last copies, before their pinned sources go


def get_host_dataloader(
    kind: str,
    worker_id: int,
    paths: List[str],
    batch_size: int,
    num_steps: Optional[int],
    data_loader_strategy: DataLoaderStrategy,
    features_config: FeaturesConfig,
    fs_config: FileSystemConfig,
    drop_remainder: bool = True,
    epoch: int = 0,
    timer: Optional[StageTimer] = None,
):
    """Generator -> batcher -> prefetching loader, with the JAX package's
    seeds: the file order and each chunk's shuffle are fixed per (worker,
    kind, epoch), and the shuffle buffer and macro batches apply to
    training only, so the validation order is stable. With
    ``bypass_dataloader`` the batcher itself is returned, without the
    prefetch thread."""
    dl_cfg: DataLoaderConfig = data_loader_strategy.data_loader_config
    if dl_cfg.process_reader:
        raise NotImplementedError("process_reader is not ported yet: ROADMAP, port queue item 6b")
    epoch_salt = 7_919 * int(epoch)
    generator = data_loader_strategy.load(
        kind, worker_id, paths, fs_config,
        seed=1_000_003 * worker_id + (29 if kind == "train" else 31) + epoch_salt,
    )
    is_train = kind == "train"
    dataset = GroupedBatchDataset(
        dataframe_generator=generator,
        features_config=features_config,
        batch_size=batch_size,
        limit=num_steps,
        drop_remainder=drop_remainder,
        columns=None,
        shuffle_buffer_batches=dl_cfg.shuffle_buffer_num_mini_batches if is_train else 0,
        macro_batches=dl_cfg.macro_batches_multiples if is_train else 1,
        seed=1_000_003 * worker_id + 17 + epoch_salt,
    )
    if dl_cfg.bypass_dataloader:
        return dataset
    return HostDataLoader(dataset, max_prefetch=dl_cfg.max_prefetch, timer=timer)
