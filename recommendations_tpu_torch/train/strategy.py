"""The training strategy: the train loop, validation, checkpoints and the
best-model export gate, on one device or over a mesh of ranks.

Port of ``train`` (``:334-754``) and ``_run_val`` (``:755``) of
``recommendations_tpu/train/strategy.py``. Both strategy names the YAMLs
use, ``pjit`` and ``single_device``, run it. The loop is the JAX
package's:

- the eval cache: the first ``validation_steps`` validation batches, kept
  on the host and run every ``val_metrics_every_n_steps`` steps;
- every ``train_metrics_every_n_steps`` steps, that step's metrics (with
  the speed, epoch and step) go to the trackers at
  ``step = samples seen``, and a NaN in the loss or the parameters stops
  the run;
- every ``checkpoint_every_k_steps`` steps, unless the loss is NaN or above
  ``export_if_loss_within_factor_of_best_model`` times the best loss seen
  after ``best_model_after_k_steps``: a full checkpoint (with
  ``checkpoint_dir``; copied to host memory in the loop and written by the
  manager's background thread, which the loop waits for before a NaN stop
  and at the end of training, so before the final export), the data
  iterator's snapshot beside it (``data_iter_h0_s<step>.pkl``), and an
  export through the model checkpointer;
- the run stops at ``train_steps`` or after ``epochs``;
- on restart from a checkpoint the step count continues, and the data
  position is restored in O(1) where it can be: from the snapshot (any
  pipeline, grouped and shuffle-buffered included, also under
  ``process_reader``, whose child answers the request), else by the
  generator's skip by file metadata (no grouping, no shuffle buffer), else
  by replaying the consumed batches, as the JAX package does;
- ``steps_per_dispatch`` = k: ``stack_step_groups`` stacks k host batches,
  one copy to the device for the group, and the k steps run with no host
  synchronisation between them; the loss and metrics reported are the
  group's last; the tail runs singly; the cadences above fire when the step
  count crosses a multiple within a group (JAX's ``_crossed``). A CUDA
  graph over the group would cut the launches further (later work);
- ``profile_dir``: ``torch.profiler`` over the steps ``profile_start_step``
  to ``profile_start_step + profile_num_steps``, its Chrome trace written
  there (``torch_trace_steps_<a>_<b>.json``);
- ``debug_numerics``: each step under ``core.debug.checked_step`` (the first
  NaN or Inf raises, naming its operation or kernel); ``steps_per_dispatch``
  then falls back to 1 with the JAX package's warning.

The lookahead offsets are drawn from the state's generator (a CPU
generator, seeded alike on every rank); validation draws its own from a
generator seeded per cached batch. Beside the JAX package's final metrics,
``step_times_s`` holds each loop turn's host wall time (a turn is a group
of k steps) and ``feed_wait_s`` each turn's wait for its batch.

Over several ranks (``torchrun``, the process group formed by
``core.mesh.init_distributed``) the strategy builds the mesh of the config's
``mesh_*`` fields (``core/mesh.py``) and binds the model to it; a node is a
JAX host:

- each node reads its own files (``data/paths.get_paths_for_worker``) and
  ``batch_size`` rows a step; each rank keeps its ``local_batch_slice`` of
  the node's rows, so the same files give JAX's global batch;
- the step sums the gradients of the whole batch's loss over the mesh
  (``train/step.py``), so every rank holds the one process's parameters;
- before each step one all-reduce of a flag on a gloo group of the hosts
  tells every rank whether any rank's shard ran out (the cooperative stop;
  the JAX package gathers its flags once a round of steps, but here each
  step holds collectives, so no rank may step alone);
- metrics to the trackers, checkpoints and exports come from rank 0 (the
  sharded parameters, and their optimizer moments, gathered whole first);
  each rank writes its own iterator snapshot; a resume slices the whole
  checkpoint back to each rank;
- after training the wrapper goes back to one device's module
  (``unbind_mesh``) for the export, the evaluation and the inference.
"""

from __future__ import annotations

import functools
import logging
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from recommendations_tpu_torch import resolve_device
from recommendations_tpu_torch.config.trainer_config import ModelTrainConfig
from recommendations_tpu_torch.config.training_strategy_config import TrainingStrategyConfig
from recommendations_tpu_torch.core import mesh as mesh_lib
from recommendations_tpu_torch.core.debug import checked_step, numerics_checked
from recommendations_tpu_torch.core.partitioning import shard_slice
from recommendations_tpu_torch.data.loader import (
    DevicePrefetcher,
    StageTimer,
    get_host_dataloader,
    stack_step_groups,
    to_device,
)
from recommendations_tpu_torch.data.paths import get_paths_for_worker
from recommendations_tpu_torch.parallel import collectives as col
from recommendations_tpu_torch.train.checkpoint import CheckpointManager
from recommendations_tpu_torch.train.step import train_step
from recommendations_tpu_torch.train.train_state import TrainState

logger = logging.getLogger(__name__)

VAL_SEED = 1234  # the JAX package validates with PRNGKey(1234) folded with the batch index


def _ram_available_gb() -> Optional[float]:
    """MemAvailable from /proc/meminfo, in GB (psutil's
    ``virtual_memory().available``)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        return None
    return None


def _host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device fetch for every metric, in sorted key order (the JAX
    package's packed metric vector)."""
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


def _slice_rows(batch: Dict[str, np.ndarray], start: int, size: int) -> Dict[str, np.ndarray]:
    return {k: v[start:start + size] for k, v in batch.items()}


def _sharded_optimizer_states(state: TrainState):
    """(state entry, mesh axis) of each optimizer-state entry of a sharded
    parameter, in ``state.state_dict()``'s layout: the optimizers'
    per-parameter states, then the accumulation's running means."""
    sharded = state.wrapper.sharded_params()
    axis_of = {p: sharded[n] for n, p in state.wrapper.module.named_parameters() if n in sharded}
    for opt_i, opt in enumerate(state.optimizer.optimizers()):
        plist = [p for g in opt.param_groups for p in g["params"]]
        for idx, p in enumerate(plist):
            if p in axis_of:
                yield ("optimizers", opt_i, idx), axis_of[p]
    for i, p in enumerate(state.optimizer.clip_params):
        if p in axis_of:
            yield ("accumulation", i), axis_of[p]


def _map_sharded(sd: dict, state: TrainState, fn) -> dict:
    """``sd`` (a ``state.state_dict()``) with ``fn(tensor, axis)`` applied
    to each row-major tensor of a sharded parameter's entries."""
    sd = dict(sd, module=dict(sd["module"]), optimizers=list(sd["optimizers"]),
              accumulation=dict(sd["accumulation"], acc=dict(sd["accumulation"]["acc"])))
    for name, axis in state.wrapper.sharded_params().items():
        sd["module"][name] = fn(sd["module"][name], axis)
    for where, axis in _sharded_optimizer_states(state):
        if where[0] == "optimizers":
            opt_sd = sd["optimizers"][where[1]] = dict(sd["optimizers"][where[1]])
            opt_sd["state"] = dict(opt_sd["state"])
            entry = opt_sd["state"].get(where[2])
            if entry is not None:
                opt_sd["state"][where[2]] = {
                    k: fn(v, axis) if torch.is_tensor(v) and v.ndim else v for k, v in entry.items()
                }
        elif where[1] in sd["accumulation"]["acc"]:
            sd["accumulation"]["acc"][where[1]] = fn(sd["accumulation"]["acc"][where[1]], axis)
    return sd


class SingleProcessTrainingStrategy:
    """The strategy of one process, or of one rank among several (the
    config's mesh over the process group)."""

    def __init__(self, training_strategy_config: TrainingStrategyConfig, device="cuda"):
        self.config = training_strategy_config
        self.device = resolve_device(device)
        self.mesh = None

    def _build_mesh(self):
        """The mesh over the process group's ranks; None in one process
        whose mesh is one device."""
        cfg = mesh_lib.mesh_config(self.config)
        if mesh_lib.world_size() == 1:
            cfg.resolved_shape(1)  # the JAX package's error for a mesh larger than the devices
            return None
        return mesh_lib.build_mesh(cfg, device=self.device)

    def _full_state(self, state: TrainState) -> dict:
        """The train state with the sharded parameters' blocks gathered (a
        collective)."""
        mesh = self.mesh
        return _map_sharded(state.state_dict(), state,
                            lambda t, axis: col.all_gather_tensor(t, mesh.group(axis)))

    def _local_state(self, sd: dict, state: TrainState) -> dict:
        """A whole checkpoint's state cut to this rank's blocks."""
        mesh = self.mesh
        return _map_sharded(sd, state, lambda t, axis: shard_slice(t, (axis,), mesh))

    def _profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def train(
        self,
        model_builder,
        data_loader_strategy,
        train_data_paths: List[str],
        val_data_paths: List[str],
        pipeline_config,
        model_checkpointer=None,
    ) -> Tuple[object, TrainState, Dict[str, float]]:
        train_cfg: ModelTrainConfig = pipeline_config.train
        # num_workers is the reference's count of hosts: the JAX strategy
        # reads the hosts from its runtime, this one from the process group
        mesh = self.mesh = self._build_mesh()
        wrapper = model_builder.build()
        rank = 0 if mesh is None else mesh.rank
        node, n_nodes = (0, 1) if mesh is None else (mesh_lib.node_index(), mesh_lib.num_nodes())
        rows = None  # this rank's (first row, rows) of its node's batch
        if mesh is not None:
            wrapper.bind_mesh(mesh)
            start, size = mesh_lib.local_batch_slice(mesh, train_cfg.batch_size * n_nodes)
            rows = (start - node * train_cfg.batch_size, size)
            if not 0 <= rows[0] <= train_cfg.batch_size - size:
                raise ValueError(f"rank {rank}'s rows {start}..{start + size} are not on its node {node}")
            train_data_paths = get_paths_for_worker(node, train_data_paths, n_nodes)
            val_data_paths = get_paths_for_worker(node, val_data_paths, n_nodes) if val_data_paths else []
            flags_group = mesh.host_group
        trackers = pipeline_config.trackers
        features = pipeline_config.model.features
        fs = pipeline_config.dataset.filesystem_config
        feed_timer = StageTimer()

        def make_loader(kind: str, paths: List[str], epoch: int = 0, skip_batches: int = 0, snapshot=None):
            return get_host_dataloader(
                kind=kind,
                worker_id=node,
                paths=paths,
                batch_size=train_cfg.batch_size,
                num_steps=None,
                data_loader_strategy=data_loader_strategy,
                features_config=features,
                fs_config=fs,
                skip_batches=skip_batches,
                epoch=epoch,
                snapshot=snapshot,
                timer=feed_timer if kind == "train" else None,
            )

        state = TrainState.create(wrapper, train_cfg)
        if mesh is not None:
            sharded = wrapper.sharded_params()
            state.optimizer.sharded_params = {
                p: mesh.group(sharded[n]) for n, p in wrapper.module.named_parameters() if n in sharded
            }
        step_fn = train_step
        k_dispatch = max(1, int(train_cfg.steps_per_dispatch))
        if getattr(self.config, "debug_numerics", False):
            step_fn = checked_step(train_step)
            if k_dispatch > 1:
                logger.warning(
                    "steps_per_dispatch=%d requested but multi-step program unavailable (debug_numerics?); using 1",
                    k_dispatch,
                )
                k_dispatch = 1

        ckpt_mgr: Optional[CheckpointManager] = None
        ckpt_dir = pipeline_config.checkpoint_dir
        resume_epoch = resume_batches = 0
        resume_snapshot: Optional[bytes] = None

        def sidecar_path(step: int) -> str:
            # each rank's iterator snapshot beside the checkpoint
            return os.path.join(ckpt_dir, f"data_iter_h{rank}_s{step}.pkl")

        if train_cfg.checkpoint_every_k_steps and ckpt_dir:
            ckpt_mgr = CheckpointManager(ckpt_dir)
            prepare = None
            if mesh is not None and wrapper.sharded_params():
                prepare = functools.partial(self._local_state, state=state)
            restored = ckpt_mgr.restore(state, prepare=prepare)
            if restored is not None:
                state, data_iter_state = restored
                logger.info("resumed from checkpoint step=%s", state.step)
                resume_epoch = int(data_iter_state.get("epoch", 0))
                resume_batches = int(data_iter_state.get("batches_in_epoch", 0))
                if data_iter_state.get("has_snapshot") and os.path.exists(sidecar_path(state.step)):
                    with open(sidecar_path(state.step), "rb") as f:
                        resume_snapshot = f.read()

        # the eval cache (reference init_eval_cache, :277-291)
        eval_cache: List[Dict[str, np.ndarray]] = []
        if train_cfg.validation_steps > 0 and val_data_paths:
            for b in make_loader("val", val_data_paths):
                eval_cache.append(b if rows is None else _slice_rows(b, *rows))
                if len(eval_cache) >= train_cfg.validation_steps:
                    break

        global_metrics: Dict[str, float] = {}
        best_loss = float("inf")
        export_cfg = pipeline_config.export
        loss_factor = (
            export_cfg.export_if_loss_within_factor_of_best_model
            if export_cfg is not None and export_cfg.export_if_loss_within_factor_of_best_model
            else float("inf")
        )
        best_after = (
            export_cfg.best_model_after_k_steps
            if export_cfg is not None and export_cfg.best_model_after_k_steps
            else 0
        )

        global_num_samples = 0
        batch_nb = state.step
        train_start = None
        stop_all = False
        last_loss = None
        step_times: List[float] = []  # each loop turn's host wall time: feed, steps, metrics, checkpoints
        feed_waits: List[float] = []  # each turn's wait for its batch (the first's holds the reader's start)
        profile_dir = getattr(self.config, "profile_dir", None)
        profile_start = getattr(self.config, "profile_start_step", 10)
        profile_steps = getattr(self.config, "profile_num_steps", 5)
        prof = None

        for epoch in range(train_cfg.epochs):
            if stop_all:
                break
            if epoch < resume_epoch:
                continue
            resuming = epoch == resume_epoch and resume_batches > 0
            snap = resume_snapshot if resuming else None
            loader = make_loader("train", train_data_paths, epoch=epoch,
                                 skip_batches=resume_batches if resuming else 0, snapshot=snap)
            it = iter(loader)
            batches_in_epoch = 0
            if resuming:
                if snap is not None:
                    # the snapshot restored the iterator; discard the few
                    # batches between its drain boundary and the checkpoint
                    for _ in range(loader.discard_batches):
                        next(it, None)
                    logger.info("restored data-iterator snapshot at epoch %d batch %d (+%d alignment batches)",
                                epoch, resume_batches, loader.discard_batches)
                elif loader.skip_applied:
                    logger.info("seeked data iterator to epoch %d batch %d (metadata skip)", epoch, resume_batches)
                else:
                    # no snapshot and no metadata skip: replay and discard
                    for _ in range(resume_batches):
                        if next(it, None) is None:
                            break
                    logger.info("fast-forwarded data iterator to epoch %d batch %d (replay)", epoch, resume_batches)
                batches_in_epoch = resume_batches
            # the next batch's copy runs while this step runs; built after
            # the replay, since it starts consuming the iterator at once
            host_it = it if rows is None else (_slice_rows(b, *rows) for b in it)
            host_it = stack_step_groups(host_it, k_dispatch) if k_dispatch > 1 else host_it
            dev_it = iter(DevicePrefetcher(host_it, self.device, depth=2, timer=feed_timer))
            t_loop_prev = None
            while not stop_all:
                t_feed = time.perf_counter()
                if t_loop_prev is not None:
                    feed_timer.add("step.loop_other", t_feed - t_loop_prev)
                item = next(dev_it, None)
                if mesh is not None:
                    # no rank steps alone: any rank out of data ends the epoch
                    (exhausted,) = col.any_rank([item is None], flags_group)
                    if exhausted:
                        break
                if item is None:
                    break
                t_disp = time.perf_counter()
                if profile_dir and prof is None and batch_nb >= profile_start:
                    prof = self._profiler()
                    prof.__enter__()
                    prof_from = batch_nb
                if k_dispatch > 1:
                    tag, batch = item
                    group = [{k: v[i] for k, v in batch.items()} for i in range(k_dispatch)] if tag == "multi" else [batch]
                else:
                    group = [item]
                for b in group:
                    loss, metrics = step_fn(state, b)
                n_new = len(group)
                feed_timer.add("step.next_batch_wait", t_disp - t_feed)
                feed_waits.append(t_disp - t_feed)
                t_loop_prev = time.perf_counter()
                feed_timer.add("step.dispatch", t_loop_prev - t_disp)
                last_loss = loss
                prev_batch_nb = batch_nb
                batch_nb += n_new
                batches_in_epoch += n_new
                if train_start is None:
                    # the steady-state clock starts after the first step
                    float(loss)
                    train_start = time.time()
                    global_num_samples = 0
                if prof is not None and batch_nb >= profile_start + profile_steps:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    prof.__exit__(None, None, None)
                    os.makedirs(profile_dir, exist_ok=True)
                    trace = os.path.join(profile_dir, f"torch_trace_steps_{prof_from}_{batch_nb}.json")
                    prof.export_chrome_trace(trace)
                    logger.info("profiler trace written to %s", trace)
                    prof, profile_dir = None, None
                global_num_samples += train_cfg.batch_size * n_nodes * n_new
                loss_val: Optional[float] = None

                def crossed(every: Optional[int]) -> bool:
                    # the step count crossed a multiple of ``every`` in this group
                    return bool(every) and every > 0 and batch_nb // every > prev_batch_nb // every

                if crossed(train_cfg.train_metrics_every_n_steps):
                    host_metrics = _host_metrics(metrics)
                    loss_val = float(loss)
                    avg = dict(host_metrics)
                    speed = global_num_samples / max(time.time() - train_start, 1e-9)
                    avg["training speed - samples per second"] = speed
                    avg["epoch"] = epoch
                    avg["steps"] = batch_nb
                    if rank == 0:
                        trackers.log_metrics(avg, step=global_num_samples)
                    logger.info("epoch %d step %d loss %.5f %.1f samples/s", epoch, batch_nb, loss_val, speed)
                    global_metrics.update(avg)
                    # the NaN watchdog (reference :374-398)
                    if math.isnan(loss_val) or host_metrics.get("params_nan", 0.0) > 0:
                        if ckpt_mgr is not None:
                            ckpt_mgr.wait()  # the last good checkpoint on disk
                        raise ValueError("Stopping: NaN in loss or parameters at step %d" % batch_nb)
                    if batch_nb >= best_after:
                        best_loss = min(best_loss, loss_val)

                if eval_cache and crossed(train_cfg.val_metrics_every_n_steps):
                    val_metrics = self._run_val(state, eval_cache, train_cfg)
                    if rank == 0:
                        trackers.log_metrics(val_metrics, step=global_num_samples)
                    global_metrics.update(val_metrics)

                if crossed(train_cfg.checkpoint_every_k_steps):
                    if loss_val is None:
                        loss_val = float(loss)
                    skip = math.isnan(loss_val) or (best_loss > 0.0 and loss_val > loss_factor * best_loss)
                    if not skip:
                        # the sharded parameters gathered whole, on every rank
                        full = None
                        if mesh is not None and wrapper.sharded_params() and (ckpt_mgr or model_checkpointer):
                            full = self._full_state(state)
                        if ckpt_mgr is not None:
                            snap_blob = loader.snapshot(batches_in_epoch)
                            if snap_blob is not None:
                                with open(sidecar_path(batch_nb), "wb") as f:
                                    f.write(snap_blob)
                            if rank == 0:
                                ckpt_mgr.save(
                                    batch_nb, state, {"loss": loss_val},
                                    data_iter_state={"epoch": epoch, "batches_in_epoch": batches_in_epoch,
                                                     "has_snapshot": snap_blob is not None},
                                    state_dict=full,
                                )
                        if model_checkpointer is not None and rank == 0:
                            # a forward over the mesh is a collective: no
                            # traced programs from rank 0 alone (the final
                            # export, on one device's module, traces them)
                            wrapper.export_weights = None if mesh is None else (
                                full["module"] if full is not None else wrapper.module.state_dict())
                            try:
                                model_checkpointer.checkpoint(state, result_df=dict(global_metrics))
                            finally:
                                wrapper.export_weights = None
                        if mesh is not None:
                            col.barrier(mesh.host_group)
                    else:
                        logger.info("skip checkpoint at %d (loss %.4f best %.4f)", batch_nb, loss_val, best_loss)

                if train_cfg.train_steps and batch_nb >= train_cfg.train_steps:
                    stop_all = True
                step_times.append(time.perf_counter() - t_feed)
            dev_it.close()
            it.close()
            if hasattr(loader, "close"):
                loader.close()  # the process reader's child

        if prof is not None:  # the run ended inside the profiled steps
            prof.__exit__(None, None, None)
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, f"torch_trace_steps_{prof_from}_{batch_nb}.json"))
        if ckpt_mgr is not None:
            ckpt_mgr.wait()
            ckpt_mgr.close()
        if last_loss is not None:
            float(last_loss)  # the device finishes before the clock is read
        elapsed = max(time.time() - train_start, 1e-9) if train_start else 0.0
        if mesh is not None:
            wrapper.unbind_mesh()
        final: Dict[str, object] = dict(global_metrics)
        final["train_steps_total"] = batch_nb
        final["train_samples_per_sec"] = global_num_samples / elapsed if elapsed else 0.0
        final["feed_path_stages"] = feed_timer.summary()
        final["step_times_s"] = step_times
        final["feed_wait_s"] = feed_waits
        feed_timer.log()
        return wrapper, state, final

    @torch.no_grad()
    def _run_val(self, state: TrainState, eval_cache, train_cfg: ModelTrainConfig) -> Dict[str, float]:
        t0 = time.time()
        wrapper = state.wrapper
        agg: Dict[str, float] = {}
        n = skipped = 0
        for i, host_batch in enumerate(eval_cache):
            batch = to_device(host_batch, self.device)
            gen = torch.Generator().manual_seed(VAL_SEED + i)
            if getattr(self.config, "debug_numerics", False):  # the JAX package checks its val step too
                with numerics_checked():
                    _, metrics, _ = wrapper.loss_and_metrics(batch, state.aux, False, generator=gen)
            else:
                _, metrics, _ = wrapper.loss_and_metrics(batch, state.aux, False, generator=gen)
            m = _host_metrics(metrics)
            if any(math.isnan(v) for v in m.values()):
                skipped += 1  # NaN val batches skipped and counted (reference :509-519)
                continue
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + v
            n += 1
        out: Dict[str, float] = {k: v / max(n, 1) for k, v in agg.items()}
        out["val_batches_skipped_nan"] = skipped
        nodes = 1 if self.mesh is None else mesh_lib.num_nodes()
        out["eval speed - samples per second"] = (
            len(eval_cache) * train_cfg.batch_size * nodes / max(time.time() - t0, 1e-9))
        ram = _ram_available_gb()
        if ram is not None:
            out["RAM Available - GB"] = ram
        return out


def get_training_strategy(training_strategy_config: TrainingStrategyConfig, device="cuda"):
    """Factory - reference ``commons/training_strategy/__init__.py:6-12``."""
    name = training_strategy_config.name
    if name in ("pjit", "single_device"):
        return SingleProcessTrainingStrategy(training_strategy_config, device=device)
    raise ValueError(f"Unknown training strategy {name!r}")
