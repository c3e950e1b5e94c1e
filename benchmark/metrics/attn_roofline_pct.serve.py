"""The attention's least time (``arith.lthm.attention_bound_s``: the bias
forward kernels' bounds over the layers) over the device time
of the kernels named in ``KERNELS``, per request. None when no listed kernel
runs."""

from __future__ import annotations

from benchmark.arith.lthm import attention_bound_s

UNIT = "%"
BETTER = "higher"
LAYER = "kernels: ops/fused_attention.py, ops/csrc/"
MOVES = "serve_users_per_s"
SOURCE = "device_trace"


KERNELS = ('mqa_tc_bias_fwd_kernel', 'mqa_mma_kernel', 'mqa_tc_bias_dq_kernel', 'mqa_mma_dq_kernel', 'mqa_tc_bias_dkv_kernel')


def read(run):
    if run.trace is None or not run.trace.has(KERNELS):
        return None
    per_unit_s = run.trace.device_us(names=KERNELS) / run.trace.units / 1e6
    return 100.0 * attention_bound_s(run.shapes, training=False) / per_unit_s
