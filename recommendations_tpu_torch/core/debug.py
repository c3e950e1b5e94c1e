"""Numerics debug mode: the first NaN or Inf an operation produces raises,
naming the operation.

Port of ``recommendations_tpu/core/debug.py`` (``checked_step``, which wraps
the step in ``checkify`` with its float checks), for the
``training_strategy.debug_numerics`` knob. ``numerics_checked`` runs a call
under

- ``NumericsMode``, a ``TorchDispatchMode`` over the forward and the
  backward. Like checkify's float checks it looks at the arithmetic
  operations (``ARITHMETIC``, the aten counterparts of checkify's
  ``nan_primitives``, and the port's custom operators) and raises
  ``FloatingPointError`` with the operation's name when an output holds a
  NaN, or an Inf that no input held (an overflow, a division by zero);
  ``log`` of an exact zero, the -inf the CE gives a fully masked row, is
  allowed;
- ``torch.autograd.detect_anomaly``, so an error raised in the backward
  also prints the forward operation it differentiates;
- ``check_kernel_outputs``, which the wrappers of the hand-written kernels
  (``ops/fused_attention.py``, ``ops/fused_ce.py``) call on what each kernel
  wrote: a kernel launched through ``ctypes`` is no aten operation, so no
  dispatch mode sees it; it is named by kernel.

``unchecked`` marks a region whose NaNs are by design: the loss's metrics,
where the median rank of a chunk without a used token is NaN. Every check
is a device synchronisation, so a checked step runs much slower: a debug
tool, not a production path.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten

_ACTIVE = [0]  # nesting depth of numerics_checked

ARITHMETIC = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "mm", "addmm", "bmm", "baddbmm", "matmul", "dot", "exp", "exp2",
    "expm1", "log", "log1p", "log2", "sqrt", "rsqrt", "pow", "reciprocal", "tanh", "sigmoid", "sin", "cos",
    "erf", "sum", "mean", "prod", "cumsum", "cumprod", "addcmul", "addcdiv", "_softmax", "_log_softmax",
    "gelu", "gelu_backward", "native_layer_norm", "native_layer_norm_backward", "linalg_vector_norm",
    "segment_reduce", "_segment_reduce_backward", "index_add", "scatter_add", "constant_pad_nd",
    "convolution", "fmod", "remainder", "tanh_backward", "sigmoid_backward", "logsumexp", "var", "std",
    "lerp", "clamp", "softplus",
})


def numerics_checking() -> bool:
    return _ACTIVE[0] > 0


def _floats(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()]


def _checked(func) -> bool:
    ns = func.namespace
    if ns != "aten":
        return ns != "prim"  # the port's custom operators
    return func._opname.rstrip("_") in ARITHMETIC


def _problem(outputs, inputs, allow_log_zero: bool):
    """'NaN', 'Inf' or None: a NaN in an output, or an Inf in an output when
    every input was finite."""
    for t in outputs:
        if bool(torch.isnan(t).any()):
            return "NaN"
    if any(not bool(torch.isfinite(t).all()) for t in inputs):
        return None
    for t in outputs:
        inf = (t == float("inf")) if allow_log_zero else torch.isinf(t)
        if bool(inf.any()):
            return "Inf"
    return None


class NumericsMode(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first arithmetic operation whose
    output holds a NaN, or an Inf that no input held."""

    def __init__(self):
        super().__init__()
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused or not _checked(func):
            return out
        bad = _problem(_floats(out), _floats((args, kwargs)), func._opname == "log")
        if bad is not None:
            raise FloatingPointError(f"debug_numerics: {bad} produced by operation {func}")
        return out


def check_kernel_outputs(kernel: str, tensors: Iterable[torch.Tensor], allow_neg_inf: bool = False) -> None:
    """Called by the kernel wrappers after a launch: raises naming the
    kernel when ``numerics_checked`` is active and an output holds a NaN or
    an Inf (-inf allowed where the kernel writes it by design)."""
    if not numerics_checking():
        return
    for t in tensors:
        if bool(torch.isnan(t).any()):
            raise FloatingPointError(f"debug_numerics: NaN produced by kernel {kernel}")
        inf = (t == float("inf")) if allow_neg_inf else torch.isinf(t)
        if bool(inf.any()):
            raise FloatingPointError(f"debug_numerics: Inf produced by kernel {kernel}")


@contextlib.contextmanager
def unchecked():
    """A region whose NaNs and Infs are by design (no-op outside
    ``numerics_checked``)."""
    modes = [m for m in _get_current_dispatch_mode_stack() if isinstance(m, NumericsMode)]
    for m in modes:
        m.paused += 1
    try:
        yield
    finally:
        for m in modes:
            m.paused -= 1


@contextlib.contextmanager
def numerics_checked():
    """The block's operations, forward and backward, are checked."""
    _ACTIVE[0] += 1
    try:
        with torch.autograd.detect_anomaly(check_nan=True), NumericsMode():
            yield
    finally:
        _ACTIVE[0] -= 1


def checked_step(step_fn: Callable) -> Callable:
    """``step_fn`` run under ``numerics_checked``: the first NaN or Inf
    raises with the operation's (or the kernel's) name."""

    @functools.wraps(step_fn)
    def wrapper(*args, **kwargs):
        with numerics_checked():
            return step_fn(*args, **kwargs)

    return wrapper
