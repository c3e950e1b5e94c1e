"""Named ranges of the port's layers on the profiler's timeline.

``span(name)`` enters ``torch.profiler.record_function(name)`` while a
profiler records, and a shared ``nullcontext`` otherwise: outside a profiler
a ``record_function`` still costs about 7 us an entry and exit on a CPU, the
check about 0.1 us. The check is made on every entry, so a profiler started
after import sees every range.

The ranges share the trace's clock with the device's events, so a reader of
the Chrome trace (``benchmark/harness/core.py``, ``phase_activity``) names
each kernel by the innermost range open on the host when it was launched,
and each idle gap of the device by the innermost range open at its middle.
A nested range therefore takes its work out of its parent's. The port's
ranges:

- ``lthm/serve``: ``user_encoder``, the whole serving call; ``lthm/step``:
  ``train_step``, the whole training step;
- ``lthm/inputs``: ``format_inputs``, the host-to-device copies and the id
  cast;
- ``lthm/forward``: the module's forward (``loss_and_metrics`` and the
  serving ``forward``);
- ``lthm/product_tower``: the KShift lookup and the product tower;
- ``lthm/attention``: an attention layer's forward (the LFM2 stack's
  grouped-query attention too), opened again in remat's rerun;
  ``lthm/attention_backward``: the flash kernels' backward;
- ``lthm/mlp``: a block's MLP (or MoE pair, or the LFM2 stack's dense
  SwiGLU), opened again in remat's rerun;
- the LFM2 stack (``nn/lfm2.py``), each opened again in remat's rerun:
  ``lthm/short_conv``, the gated short convolution; ``lthm/moe_route``,
  the router, its top-k, weights, counts and the rows' permutation;
  ``lthm/moe_experts``, the grouped products and their SwiGLU;
  ``lthm/moe_combine``, the rows back to their tokens and their weighted
  sum; in the backward ``lthm/moe_backward``, the routed MoE's, and inside
  it ``lthm/moe_experts_backward``, the grouped products' and SwiGLU's;
- ``lthm/loss``: the contrastive loss; inside it ``lthm/logq`` (the logQ
  update) and ``lthm/loss_metrics`` (the metrics and their host reads);
  ``lthm/ce_backward``: the CE's backward;
- ``lthm/backward``, ``lthm/optimizer``: the training step's phases.

The backward's ranges open on the autograd engine's thread.

Counters (``count(name, values)``): int64 device tensors that a layer adds
to while a profiler records, never in the backward's rerun of a forward
(remat) and never when no profiler records, where ``count`` returns after
the same check as ``span``. They are read after the profiled steps
(``counters()``), never inside one; ``reset_counters`` drops them. The
port's counters:

- ``lthm/moe_tokens/block_<i>``: the (token, slot) rows routed to each
  expert of the LFM2 stack's MoE layer i, (E,).

Host tallies (``tally(name)``): counts kept on the host, added to on every
call whether or not a profiler records, doing no device work; ``counters()``
returns them too, as 0-dim int64 CPU tensors, and ``reset_counters`` drops
them with the rest. The port's tallies:

- ``lthm/step_graph/replays``: training steps that replayed the captured
  step (``train/step_graph.py``), its capture included;
- ``lthm/step_graph/eager``: training steps that ran eager.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
# the profiler's counters, by name (module docstring); process-wide, as the
# profiler itself is
_COUNTERS: Dict[str, torch.Tensor] = {}
_TALLIES: Dict[str, int] = {}


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    context that does nothing."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF


def count(name: str, values: torch.Tensor) -> None:
    """Add ``values`` to the counter ``name`` (made on first use, zeros of
    their shape and device, int64) while a profiler records and outside a
    backward; else do nothing."""
    if not torch.autograd._profiler_enabled() or torch._C._current_graph_task_id() != -1:
        return
    c = _COUNTERS.get(name)
    if c is None or c.shape != values.shape or c.device != values.device:
        c = _COUNTERS[name] = torch.zeros(values.shape, dtype=torch.int64, device=values.device)
    c.add_(values)


def tally(name: str) -> None:
    """Add one to the host tally ``name``, profiler or not."""
    _TALLIES[name] = _TALLIES.get(name, 0) + 1


def counters() -> Dict[str, torch.Tensor]:
    """The counters so far, by name (the tensors themselves), and the host
    tallies."""
    return {**_COUNTERS, **{k: torch.tensor(v, dtype=torch.int64) for k, v in _TALLIES.items()}}


def reset_counters() -> None:
    _COUNTERS.clear()
    _TALLIES.clear()
