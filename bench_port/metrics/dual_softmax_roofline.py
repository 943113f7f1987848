"""Kernel B (``ops/kernels/dual_softmax.py``, ``csrc/dual_softmax.cu``) in
the match cells: the least time of its launches (one a forward) over the
device time of its passes and combines."""
from bench_port.counts.kernels import dual_softmax
from bench_port.metrics._common import roofline

UNIT = "%"
KERNELS = ("dual_softmax_bf16", "stats_combine", "best_combine",
           "tile_kernel", "lse_combine_kernel", "best_combine_kernel",
           "max_combine_kernel")


def read(ctx):
    if ctx["kind"] != "offline":
        return None
    n = ctx["launches"].get("dual_softmax", 0)
    f, b = dual_softmax(ctx["B"], ctx["L"], ctx["S"])
    return roofline(ctx, KERNELS, f * n, b * n)
