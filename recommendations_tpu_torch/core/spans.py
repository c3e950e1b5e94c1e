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
- ``lthm/attention``: an attention layer's forward, opened again in remat's
  rerun; ``lthm/attention_backward``: the flash kernels' backward;
- ``lthm/mlp``: a block's MLP (or MoE pair), opened again in remat's rerun;
- ``lthm/loss``: the contrastive loss; inside it ``lthm/logq`` (the logQ
  update) and ``lthm/loss_metrics`` (the metrics and their host reads);
  ``lthm/ce_backward``: the CE's backward;
- ``lthm/backward``, ``lthm/optimizer``: the training step's phases.

The backward's ranges open on the autograd engine's thread.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    context that does nothing."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
