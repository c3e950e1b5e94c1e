"""The training step captured once as a CUDA graph and replayed.

``train_step`` (``train/step.py``) runs eager until the step may be
captured, then captures the whole step (``zero_grad``, the forward, the
loss with its logQ update, the backward, the gradient norm, the optimizer,
the NaN check and the new aux state) as one ``torch.cuda.CUDAGraph`` and
replays it on every later step whose batch has the captured shapes. A
replay launches the step's thousands of kernels in one call, so the step
runs at the device's pace instead of the host's dispatch.

The step may be captured when ``eager_reason`` finds nothing against it:

- no profiler records (its ranges name each kernel by the range open at
  its launch, and inside a replay every kernel belongs to the one launch);
- the wrapper's device is CUDA and it has no mesh;
- every dropout rate is 0 (a replay would draw the captured step's masks);
- the table path is frozen or dense (the lazy and fused tables' row sets
  change size from step to step);
- no gradient accumulation and no learning-rate schedule (the optimizer
  steps on every call, at a rate fixed in the graph);
- the batch's tensors are on the card;
- the warm-up made no synchronizing call, no capture of this state has
  failed or been refused, and the batch has the captured shapes and dtypes.

The first such step runs eager, as the warm-up (every kernel built, the
optimizer's state made), under torch's sync debug mode: a step that reads
a device value on the host cannot be captured (and a capture that fails
midway leaves the default CUDA generator unusable), so one that does runs
eager from then on. The next step captures and replays, unless the graph's
private pool would not fit beside what the device holds: the capture is
refused where twice the warm-up's transient memory (the allocator's peak so
far less what is allocated at the capture) is more than the device's free
memory once the eager pool's cached blocks are released. Twice: a pool
reuses fewer of the blocks freed inside its capture than the eager pool
does (on an H100 the LFM2 stack's step at 64 users of 1024 events ran out
of memory in its capture with 18 GiB reserved in its pool, 3.9 of them
allocated). A refused capture, or one that fails, leaves the state eager
from then on. Before its capture every AdamW is made ``capturable``
(``make_capturable``: the step count on the device), for the graph and
for every later step of the state, eager or not; a set-up that never
captures keeps torch's other path. The graph is dropped with
``TrainState.load_state_dict`` and where an optimizer's state was replaced;
that step runs eager as the warm-up of the next capture.

A replay does on the host: copy the batch into the graph's input buffers,
copy the step's offsets (drawn on the host as before, so the draws follow
the eager steps') through a pinned slot into the graph's offsets buffer,
launch, add the launches the capture counted to the hand-written kernels'
counts (``ops/cuda_build.py``), and clone the loss and metrics out of the
graph's buffers, so what it returns is the caller's own. The host runs at
most ``RUN_AHEAD`` steps ahead of the device: before it enqueues a step it
waits on the event of the step ``RUN_AHEAD`` before, whose pinned slot it
then reuses.

The aux state is functional in the step; the graph reads it from fixed
buffers, so the captured step copies the new aux state into them, and after
a replay ``state.aux`` is those buffers. An eager step in between leaves new
tensors in ``state.aux``, which the next replay copies in. An eager step
while a graph is held runs beside the graph's private memory pool; where
the device's free memory would not hold another step of that size, the
graph is dropped first.

``core/spans.py`` tallies each step under ``lthm/step_graph/replays`` or
``lthm/step_graph/eager``.
"""

from __future__ import annotations

import contextlib
import gc
import logging
import warnings
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten

from recommendations_tpu_torch.core.spans import tally
from recommendations_tpu_torch.nn.dropout import dropout_rates
from recommendations_tpu_torch.ops.cuda_build import ALL_KERNELS

log = logging.getLogger(__name__)

RUN_AHEAD = 2  # steps the host may enqueue before the device has run them
SYNC_WARNING = "called a synchronizing CUDA operation"  # torch's sync debug mode

# eager_reason's answers
PROFILER = "a profiler records"
NOT_CUDA = "not a CUDA device"
MESH = "a mesh"
DROPOUT = "a dropout rate above 0"
ROW_SPARSE_TABLE = "a lazy or fused table"
ACCUMULATION = "gradient accumulation"
SCHEDULE = "a learning-rate schedule"
BATCH_OFF_CARD = "a batch off the card"
NO_CAPTURE = "the capture failed or would not fit"
NEW_SHAPE = "a batch of other shapes"

Body = Callable[[Any, Mapping[str, torch.Tensor], Any, int], Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]]


def signature(batch: Mapping[str, Any], offsets) -> tuple:
    """The shapes and dtypes a captured step was made for."""
    items = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))
    return items, None if offsets is None else tuple(torch.as_tensor(offsets).shape)


def eager_reason(state, batch: Mapping[str, Any], offsets=None) -> Optional[str]:
    """Why this step of ``state`` runs eager (the module's list), or None
    when it replays the captured step."""
    if torch.autograd._profiler_enabled():
        return PROFILER
    wrapper = state.wrapper
    if torch.device(wrapper.device).type != "cuda":
        return NOT_CUDA
    if wrapper.mesh is not None:
        return MESH
    if any(rate > 0 for rate in dropout_rates(wrapper.module)):
        return DROPOUT
    if wrapper.uses_lazy_table() or wrapper.uses_sparse_taps():
        return ROW_SPARSE_TABLE
    if state.optimizer.accumulate > 1:
        return ACCUMULATION
    if state.optimizer.scheduler is not None:
        return SCHEDULE
    held = state.graph
    if held is not None:
        if held.failed:
            return NO_CAPTURE
        if held.signature != signature(batch, offsets):
            return NEW_SHAPE
    if not all(isinstance(v, torch.Tensor) and v.is_cuda for v in batch.values()):
        return BATCH_OFF_CARD
    return None


def make_capturable(optimizer) -> None:
    """Every AdamW of the ``TrainOptimizer`` capturable from now on: each
    group's flag set and each step count moved to its parameter's device as
    float32, as torch keeps it there. The update is the same, a few
    roundings apart (the bias corrections are formed on the device)."""
    for opt in optimizer.optimizers():
        if not isinstance(opt, torch.optim.AdamW):
            continue
        for group in opt.param_groups:
            group["capturable"] = True
            for p in group["params"]:
                st = opt.state.get(p, {})
                if "step" in st and st["step"].device != p.device:
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)


def _optimizer_states(state) -> tuple:
    """The optimizers' state dicts, which ``load_state_dict`` replaces."""
    return tuple(id(opt.state) for opt in state.optimizer.optimizers())


class StepGraph:
    """The captured step of one ``TrainState`` (``state.graph``): made by a
    warm-up step for the batch's ``signature``, captured by the next."""

    def __init__(self, sig: tuple, failed: bool = False):
        self.signature = sig
        self.failed = failed
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.params: list = []

    def replay(self, state, batch: Mapping[str, torch.Tensor], offsets, dropout_seed: int,
               body: Body) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """This step through the graph, captured first if it is not yet;
        None where it runs eager: the capture failed, or an optimizer's
        state was replaced (this step then warms up a new capture)."""
        if self.graph is not None and self.optimizer_states != _optimizer_states(state):
            state.graph = StepGraph(self.signature)
            return None
        if self.graph is None:
            return self._capture(state, batch, offsets, dropout_seed, body)
        slot = self.calls % RUN_AHEAD
        self.events[slot].synchronize()  # the step RUN_AHEAD before has run
        self._feed(state, batch, offsets, slot)
        self.graph.replay()
        for kern, n in self.launched:
            kern.launches += n
        return self._outputs(slot)

    def _feed(self, state, batch, offsets, slot: int) -> None:
        """This step's inputs into the graph's buffers, in stream order."""
        for k, v in batch.items():
            self.batch[k].copy_(v, non_blocking=True)
        if self.offsets is not None:
            self.staging[slot].copy_(torch.as_tensor(offsets).reshape(self.offsets.shape))
            self.offsets.copy_(self.staging[slot], non_blocking=True)
        if state.aux is not self.aux:  # an eager step left its own
            for dst, src in zip(tree_flatten(self.aux)[0], tree_flatten(state.aux)[0]):
                if dst is not src:
                    dst.copy_(src)
            state.aux = self.aux
        if self.params and self.params[0].grad is not self.grads[0]:
            for p, g in zip(self.params, self.grads):
                p.grad = g

    def _outputs(self, slot: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Fresh copies of the loss and metrics; the slot's event recorded."""
        fresh = {dtype: t.clone() for dtype, t in self.packed.items()}
        self.events[slot].record()
        self.calls += 1
        out = {key: fresh[dtype][at:at + n].view(shape) for key, dtype, at, n, shape in self.layout}
        return out.pop(None), out

    def _capture(self, state, batch, offsets, dropout_seed: int, body: Body):
        device = torch.device(state.wrapper.device)
        # the warm-up's gradients freed, the eager pool's free blocks released
        state.optimizer.zero_grad()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        need = 2 * (torch.cuda.max_memory_allocated(device) - torch.cuda.memory_allocated(device))
        free = torch.cuda.mem_get_info(device)[0]
        if need > free:
            log.warning("the training step is not captured as a CUDA graph: its pool may need %.2f GiB beside "
                        "what the device holds, %.2f GiB are free; it runs eager", need / 2**30, free / 2**30)
            state.graph = StepGraph(self.signature, failed=True)
            return None
        self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self.offsets = None
        if offsets is not None:
            host = torch.as_tensor(offsets).to(torch.int64)
            self.offsets = torch.empty(host.shape, dtype=torch.int64, device=device)
            self.staging = [torch.empty(host.shape, dtype=torch.int64).pin_memory() for _ in range(RUN_AHEAD)]
        self.events = [torch.cuda.Event() for _ in range(RUN_AHEAD)]
        self.calls = 0
        self.aux = state.aux
        self._feed(state, batch, offsets, 0)
        make_capturable(state.optimizer)
        torch.cuda.synchronize(device)
        reserved = torch.cuda.memory_reserved(device)
        launches = [kern.launches for kern in ALL_KERNELS]
        graph = torch.cuda.CUDAGraph()
        failed = False
        try:
            # the outer stream context restores the stream where the capture's end raises
            with torch.cuda.stream(torch.cuda.current_stream(device)), torch.cuda.graph(graph):
                loss, metrics, new_aux = body(state, self.batch, self.offsets, dropout_seed)
                for dst, src in zip(tree_flatten(self.aux)[0], tree_flatten(new_aux)[0]):
                    if dst is not src:
                        dst.copy_(src)
                self._pack(loss, metrics)
        except RuntimeError as err:  # a read of a device value, a launch refused, no memory
            log.warning("the training step could not be captured as a CUDA graph; it runs eager: %s", err)
            failed = True
        if failed:
            # nothing of the capture kept: its tensors freed, its pool released
            state.graph = StepGraph(self.signature, failed=True)
            state.optimizer.zero_grad()
            del graph
            self.__dict__.clear()
            gc.collect()
            torch.cuda.empty_cache()
            return None
        self.graph = graph
        # the capture counted its launches once, for the replay below
        self.launched = [(kern, kern.launches - n) for kern, n in zip(ALL_KERNELS, launches) if kern.launches > n]
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.optimizer_states = _optimizer_states(state)
        self.params = [p for p in state.optimizer.clip_params if p.grad is not None]
        self.grads = [p.grad for p in self.params]
        graph.replay()
        return self._outputs(0)

    def _pack(self, loss: torch.Tensor, metrics: Dict[str, torch.Tensor]) -> None:
        """The loss and metrics laid end to end, one buffer per dtype, inside
        the capture: a replay clones one buffer per dtype."""
        parts: Dict[torch.dtype, list] = {}
        self.layout = []
        for key, t in [(None, loss), *metrics.items()]:
            group = parts.setdefault(t.dtype, [])
            at = sum(x.numel() for x in group)
            self.layout.append((key, t.dtype, at, t.numel(), tuple(t.shape)))
            group.append(t.detach().reshape(-1))
        self.packed = {dtype: torch.cat(group) for dtype, group in parts.items()}

    def eager_fits(self, device) -> bool:
        """Whether an eager step of the captured size fits beside the
        graph's pool: the device's free memory and the allocator's cached
        bytes, less what the graph's pool holds."""
        free, _ = torch.cuda.mem_get_info(device)
        cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        return free + cached - self.pool_bytes >= self.pool_bytes


def run(state, batch: Mapping[str, Any], offsets, dropout_seed: int,
        body: Body) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One step of ``state``: through the graph (``state.graph``) where the
    rule allows it, else eager, the warm-up of a capture watched for
    synchronizing calls; tallied either way. ``state.step`` is left to the
    caller."""
    reason = eager_reason(state, batch, offsets)
    held = state.graph
    if reason is None and held is not None:
        out = held.replay(state, batch, offsets, dropout_seed, body)
        if out is not None:
            tally("lthm/step_graph/replays")
            return out
    elif reason is None or (reason == NEW_SHAPE and held.graph is None):
        # this eager step is the warm-up of a capture for the batch's shapes
        state.graph = StepGraph(signature(batch, offsets))
        with _synchronizing_calls() as found:
            loss, metrics, state.aux = body(state, batch, offsets, dropout_seed)
        if found:
            log.warning("the training step reads a device value on the host (%s); it runs eager", found[0])
            state.graph.failed = True
        tally("lthm/step_graph/eager")
        return loss, metrics
    elif held is not None and held.graph is not None and not held.eager_fits(state.wrapper.device):
        state.graph = None
    tally("lthm/step_graph/eager")
    loss, metrics, state.aux = body(state, batch, offsets, dropout_seed)
    return loss, metrics


@contextlib.contextmanager
def _synchronizing_calls():
    """The synchronizing calls made inside, as torch's sync debug mode
    warns of them (the autograd engine's replayed in this thread at the end
    of a backward), the mode put back after; other warnings pass on."""
    mode = torch.cuda.get_sync_debug_mode()
    found = []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield found
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    for w in seen:
        if SYNC_WARNING in str(w.message):
            found.append(str(w.message))
        else:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
