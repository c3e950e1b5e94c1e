"""The single-GPU training step.

Port of ``train_step`` in ``recommendations_tpu/train/strategy.py`` (as
``bench.py`` times it). It calls the wrapper only through the contract of
``models/base.py``, so a wrapper without a table (the ranker) trains on
the dense path. The three table paths:

- dense (``frozen``, ``adamw``, ``rowwise_adam``): forward, loss and
  backward, then the optimizer step over every group;
- lazy (``lazy_rowwise_adam``): the same, and ``apply_lazy_table_update``
  on the table's gradient as the backward left it, before clipping;
- taps (``sparse_fused_adam``): the gradient is taken of the parameters and
  of the wrapper's taps, the optimizer steps the dense parameters, then
  ``apply_sparse_table_update`` steps the record's touched rows from the
  taps' gradient (unclipped, as in the JAX package).

With gradient accumulation (``TrainOptimizer.accumulate`` > 1) the
optimizer steps on every k-th call only, while the lazy and fused table
updates, the aux state and ``step`` advance on every call, as in the JAX
package, where they sit outside ``optax.MultiSteps``.

The forward's dropout masks come from ``state.next_dropout_seed()``, one
draw a step (the JAX step's forward key); the offsets from
``state.generator`` (its loss key), drawn by the wrapper's
``draw_offsets`` before the step runs.

On a card the step is captured as one CUDA graph and replayed where
``train/step_graph.py`` allows it (no profiler, no mesh, no dropout, a
frozen or dense table, no accumulation, the captured shapes); elsewhere it
runs eager. Both run ``step_body``, and give the same bits.

Then the new aux state; the metrics ``grad_norm`` (of the raw gradients,
with the taps' squares summed over every occurrence) and ``params_nan``
(every parameter but the fused record, whose written rows the update checks
itself: its ``rows_nan`` is folded in); ``step += 1``.

On a mesh (the wrapper's ``mesh``, ``core/mesh.py``) each rank holds its
rows' part of the whole batch's loss, so after the backward every
parameter's gradient is summed over the axes ``param_grad_axes`` names
(``reduce_gradients``: one all-reduce per set of axes over the gradients
laid end to end; the sum of a gradient that comes out of a bf16 product
rounded to bf16 again, as JAX's partitioned backward rounds it), before
the lazy table update, the norm and the clipping; the fused record's
(row, gradient) pairs are gathered by the wrapper's update instead. The
norm counts each sharded parameter's blocks once
(``optimizers.global_norm``), and ``params_nan`` is any rank's.

The step runs inside the range ``lthm/step`` and its phases inside
``lthm/...`` ranges (``core/spans.py``: forward and loss in the wrapper, the
layers inside them in the modules, the CE backward in the loss), which
``python3 benchmark/run.py --trace 1`` and the trainer's ``profile_dir``
trace; outside a profiler a range costs one check.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from recommendations_tpu_torch.core.spans import span
from recommendations_tpu_torch.parallel import collectives as col
from recommendations_tpu_torch.train import step_graph
from recommendations_tpu_torch.train.optimizers import global_norm
from recommendations_tpu_torch.train.train_state import TrainState

Metrics = Dict[str, torch.Tensor]


def reduce_gradients(wrapper) -> None:
    """Sum each parameter's gradient over its ``param_grad_axes``, in place;
    a parameter cast for a product in a narrower float (``product_dtype``,
    ``nn.functional.cast_param``) has the sum rounded to that float."""
    mesh = wrapper.mesh
    by_axes: Dict[Tuple[str, ...], list] = {}
    grad_axes = wrapper.param_grad_axes()
    for name, p in wrapper.module.named_parameters():
        axes = grad_axes.get(name, ())
        if p.grad is not None and mesh.group(*axes) is not None:
            by_axes.setdefault(axes, []).append(p)
    for axes, params in by_axes.items():
        # in the parameters' order, the same on every rank
        for dtype in dict.fromkeys(p.grad.dtype for p in params):
            same = [p for p in params if p.grad.dtype == dtype]
            flat = torch.cat([p.grad.reshape(-1) for p in same])
            col.all_reduce_(flat, mesh.group(*axes))
            offset = 0
            for p in same:
                g = p.grad
                total = flat[offset:offset + g.numel()].view_as(g)
                narrow = getattr(p, "product_dtype", None)
                g.copy_(total if narrow is None else total.to(narrow))
                offset += g.numel()


def train_step(
    state: TrainState, batch: Mapping[str, Any], offsets=None
) -> Tuple[torch.Tensor, Metrics]:
    """One step in place on ``state``; returns (loss, metrics) as device
    tensors of the caller's own. ``offsets`` overrides the draw from
    ``state.generator``."""
    with span("lthm/step"):
        if offsets is None:
            offsets = state.wrapper.draw_offsets(state.generator)
        out = step_graph.run(state, batch, offsets, state.next_dropout_seed(), step_body)
        state.step += 1
        return out


def step_body(state: TrainState, batch: Mapping[str, Any], offsets,
              dropout_seed: int) -> Tuple[torch.Tensor, Metrics, Any]:
    """The step's device work on ``state``'s parameters, optimizer and table
    state: (loss, metrics, new aux state); ``state.aux`` and ``state.step``
    are left to the caller."""
    wrapper = state.wrapper
    use_taps = wrapper.uses_sparse_taps()
    state.optimizer.zero_grad()
    taps = wrapper.make_taps(batch) if use_taps else None
    loss, metrics, new_aux = wrapper.loss_and_metrics(
        batch, state.aux, True, offsets=offsets, generator=state.generator, taps=taps,
        dropout_seed=dropout_seed,
    )
    with span("lthm/backward"):
        loss.backward()
    params = list(wrapper.module.parameters())
    mesh = getattr(wrapper, "mesh", None)
    with span("lthm/optimizer"), torch.no_grad():
        if mesh is not None:
            reduce_gradients(wrapper)
        grads = [p.grad for p in params if p.grad is not None]
        if use_taps:
            # a tap's gradient is None when the product tower detaches it
            taps = {k: t.grad if t.grad is not None else torch.zeros_like(t) for k, t in taps.items()}
        if mesh is None:
            squares = [g.float().square().sum() for g in grads]
            if use_taps:
                squares += [g.float().square().sum() for g in taps.values()]
            metrics["grad_norm"] = torch.stack(squares).sum().sqrt()
        else:
            # each rank's taps are its own rows': summed over the data group
            sharded = state.optimizer.sharded_grads()
            if use_taps:
                sharded.update({id(g): mesh.group("data") for g in taps.values()})
                grads += list(taps.values())
            metrics["grad_norm"] = global_norm(grads, sharded)
        if wrapper.uses_lazy_table():
            table = wrapper.lazy_table()
            grad = table.grad if table.grad is not None else torch.zeros_like(table)
            # before the optimizer step, whose clipping scales the gradients in place
            state.table_state = wrapper.apply_lazy_table_update(grad, state.table_state, batch)
        state.optimizer.step()
        rows_nan = None
        if use_taps:
            state.table_state, rows_nan = wrapper.apply_sparse_table_update(taps, state.table_state, batch)
        nan = torch.stack([p.isnan().any() for p in wrapper.nan_check_params().values() if p.is_floating_point()])
        params_nan = nan.any() if rows_nan is None else nan.any() | rows_nan
        metrics["params_nan"] = params_nan.float()
        if mesh is not None:
            col.all_reduce_(metrics["params_nan"], mesh.group(*mesh.axis_names), op=torch.distributed.ReduceOp.MAX)
    # the whole batch's loss (on a mesh, ``loss`` is this rank's part of it)
    return (loss.detach() if mesh is None else metrics["train_loss"]), metrics, new_aux
