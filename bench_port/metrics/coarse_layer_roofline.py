"""Kernel A (``ops/kernels/coarse_layer.py``, ``csrc/coarse_layer.cu``)
in the match cells: the least time of every launch of the window (the
coarse stack's 12 a forward, at their shapes) over the device time of the
kernel's passes."""
from bench_port.counts.kernels import coarse_stack_forward
from bench_port.metrics._common import roofline

UNIT = "%"
KERNELS = ("kv_partial_bf16", "apply_bf16", "kv_reduce_kernel",
           "kv_partial_kernel", "apply_kernel")


def read(ctx):
    if ctx["kind"] != "offline":
        return None
    f, b, per_forward = coarse_stack_forward(ctx["B"], ctx["L"], ctx["S"])
    forwards = ctx["launches"].get("coarse_layer", 0) / per_forward
    return roofline(ctx, KERNELS, f * forwards, b * forwards)
