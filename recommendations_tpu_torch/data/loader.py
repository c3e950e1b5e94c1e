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
host) do not go to the device, as in the JAX package.

``process_reader`` runs the batcher in a child process, which does data
work only and never touches CUDA. The JAX package forks; the parent here
holds CUDA and threads, so the child is spawned: it gets the pickled
dataset (the generator's recipe, which carries the in-memory store's
tables it reads, ``data/generator.py``) and yields the same batches as the
thread reader. A failure in the child is raised in the parent. The parent
asks the child for its resume snapshots over a command queue, which the
child serves between batches, so a checkpoint of a process-read run keeps
its O(1) resume (the JAX package writes none there and replays).

``stack_step_groups`` groups the batches for ``steps_per_dispatch``.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import pickle
import queue
import threading
import time
import traceback
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


def _process_reader_main(dataset_blob: bytes, data_q, cmd_q, reply_q) -> None:
    """The child of ``process_reader``: iterate the dataset, put each batch
    on ``data_q``, and between batches answer the parent's snapshot
    requests; data work only, no CUDA."""

    def serve():
        while True:
            try:
                cmd = cmd_q.get_nowait()
            except queue.Empty:
                return
            if cmd[0] == "snap":
                reply_q.put(dataset.snapshot(cmd[1]))

    parent = mp.parent_process()

    def put(item):
        while True:
            serve()
            try:
                data_q.put(item, timeout=0.05)
                return
            except queue.Full:
                if not parent.is_alive():  # no consumer left: end with it
                    raise SystemExit(0)

    try:
        dataset = pickle.loads(dataset_blob)
        for batch in dataset:
            put(("b", pickle.dumps(batch, protocol=5)))
        put(("done", None))
    except BaseException as e:  # raised again in the parent
        put(("err", f"{e!r}\n{traceback.format_exc()}"))
    while parent.is_alive():  # the parent may still ask for a snapshot; it ends the child
        try:
            cmd = cmd_q.get(timeout=1.0)
        except queue.Empty:
            continue
        if cmd[0] == "snap":
            reply_q.put(dataset.snapshot(cmd[1]))


class HostDataLoader:
    """Fixed-shape numpy batches from a background thread (or, with
    ``process_reader``, a spawned child process), at most ``max_prefetch``
    ahead."""

    def __init__(
        self,
        dataset: GroupedBatchDataset,
        max_prefetch: int = 2,
        timer: Optional[StageTimer] = None,
        process_reader: bool = False,
    ):
        self._dataset = dataset
        self._max_prefetch = max(1, max_prefetch)
        self.timer = timer
        self._process_reader = process_reader
        self._child = None  # (process, command queue, reply queue) while iterating in a child
        # set by get_host_dataloader: an O(1) resume was applied, and the
        # batches to discard after a snapshot restore
        self.skip_applied = False
        self.discard_batches = 0

    @property
    def dataset(self) -> GroupedBatchDataset:
        return self._dataset

    def snapshot(self, consumed_batches: int) -> Optional[bytes]:
        """The dataset's resume snapshot at ``consumed_batches`` (asked of
        the child under ``process_reader``; it stays up after its last batch
        until ``close``, since a prefetching consumer reaches the end before
        it has used every batch)."""
        if self._child is None:
            return self._dataset.snapshot(consumed_batches)
        proc, cmd_q, reply_q = self._child[:3]
        cmd_q.put(("snap", consumed_batches))
        while True:
            try:
                return reply_q.get(timeout=1.0)
            except queue.Empty:
                if not proc.is_alive():
                    raise RuntimeError("process_reader child ended before answering a snapshot request")

    def close(self) -> None:
        """End the child process of ``process_reader``, if one is up."""
        if self._child is None:
            return
        proc, *queues = self._child
        self._child = None
        if proc.is_alive():
            proc.terminate()
        proc.join(timeout=10)
        for q in queues:
            q.cancel_join_thread()
            q.close()

    def _iter_process(self) -> Iterator[Dict[str, np.ndarray]]:
        self.close()
        ctx = mp.get_context("spawn")
        data_q = ctx.Queue(maxsize=self._max_prefetch)
        cmd_q, reply_q = ctx.Queue(), ctx.Queue()
        proc = ctx.Process(target=_process_reader_main, daemon=True,
                           args=(pickle.dumps(self._dataset, protocol=5), data_q, cmd_q, reply_q))
        proc.start()
        self._child = (proc, cmd_q, reply_q, data_q)
        timer = self.timer
        done = False
        try:
            while True:
                t0 = time.perf_counter()
                while True:
                    try:
                        tag, payload = data_q.get(timeout=1.0)
                        break
                    except queue.Empty:
                        if not proc.is_alive():
                            raise RuntimeError(f"process_reader child exited with code {proc.exitcode}")
                if timer is not None:
                    timer.add("host.consumer_wait", time.perf_counter() - t0)
                if tag == "done":
                    done = True  # the child stays up for snapshot requests until close()
                    return
                if tag == "err":
                    raise RuntimeError(f"process_reader child failed:\n{payload}")
                yield pickle.loads(payload)
        finally:
            if not done:
                self.close()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self._process_reader:
            yield from self._iter_process()
            return
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


def stack_step_groups(host_iter, k: int):
    """Group host batches for ``steps_per_dispatch`` = k: ``("multi",
    {key: (k, B, ...)})`` for each full group (object columns dropped), and
    ``("single", batch)`` for each batch of the trailing partial group, so
    no batch is dropped."""
    buf: List[Dict[str, np.ndarray]] = []
    for hb in host_iter:
        buf.append(hb)
        if len(buf) == k:
            yield ("multi", {key: np.stack([b[key] for b in buf]) for key in buf[0]
                             if getattr(buf[0][key], "dtype", None) is not None and buf[0][key].dtype != object})
            buf = []
    for b in buf:
        yield ("single", b)


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's numeric columns as tensors on ``device`` (a blocking
    copy; as they are on the CPU). Object columns stay behind."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items() if v.dtype != object}


class DevicePrefetcher:
    """Host batches -> device batches, ``depth`` ahead: on a card the copies
    run on a side stream while the steps before run, and the step's stream
    waits for a batch's copy before the batch is handed out. A tagged item
    ``(tag, batch)`` (``stack_step_groups``'s) comes out as ``(tag, device
    batch)``."""

    def __init__(self, host_iter, device: torch.device, depth: int = 2, timer: Optional[StageTimer] = None):
        self._it = host_iter
        self._device = torch.device(device)
        self._depth = max(1, depth)
        self.timer = timer

    def __iter__(self):
        if self._device.type != "cuda":
            for hb in _timed_iter(self._it, self.timer, "dev.host_iter_wait"):
                yield (hb[0], to_device(hb[1], self._device)) if isinstance(hb, tuple) else to_device(hb, self._device)
            return
        stream = torch.cuda.Stream(self._device)
        pending: deque = deque()  # (device batch, its copies' event), not yet handed out
        pinned: deque = deque()  # (event, pinned sources) until the copies have completed

        def ready(item):
            tag, batch, event = item
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)  # the copy stream's memory is now the step's
            while pinned and pinned[0][0].query():
                pinned.popleft()
            return batch if tag is None else (tag, batch)

        try:
            for hb in _timed_iter(self._it, self.timer, "dev.host_iter_wait"):
                t0 = time.perf_counter()
                tag, hb = hb if isinstance(hb, tuple) else (None, hb)
                sources = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                           for k, v in hb.items() if v.dtype != object}
                with torch.cuda.stream(stream):
                    batch = {k: t.to(self._device, non_blocking=True) for k, t in sources.items()}
                event = torch.cuda.Event()
                event.record(stream)
                pinned.append((event, sources))
                if self.timer is not None:
                    self.timer.add("dev.device_put", time.perf_counter() - t0)
                pending.append((tag, batch, event))
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
    skip_batches: int = 0,
    epoch: int = 0,
    snapshot: Optional[bytes] = None,
    timer: Optional[StageTimer] = None,
):
    """Generator -> batcher -> prefetching loader, with the JAX package's
    seeds: the file order and each chunk's shuffle are fixed per (worker,
    kind, epoch), and the shuffle buffer and macro batches apply to
    training only, so the validation order is stable. With
    ``bypass_dataloader`` the batcher itself is returned, without the
    prefetch thread.

    Resume: a ``snapshot`` is restored into the batcher (the caller then
    discards ``discard_batches`` batches); otherwise ``skip_batches`` asks
    for the skip by file metadata where the batcher allows it.
    ``skip_applied`` on the result says whether either took effect; where
    neither did, the caller replays the batches."""
    dl_cfg: DataLoaderConfig = data_loader_strategy.data_loader_config
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
    discard = 0
    if snapshot is not None:
        discard = dataset.restore_snapshot(snapshot)
        skip_applied = True
    else:
        skip_applied = bool(skip_batches) and dataset.request_skip(skip_batches)
    loader = dataset if dl_cfg.bypass_dataloader else HostDataLoader(
        dataset, max_prefetch=dl_cfg.max_prefetch, timer=timer, process_reader=dl_cfg.process_reader)
    loader.skip_applied = skip_applied
    loader.discard_batches = discard
    return loader
