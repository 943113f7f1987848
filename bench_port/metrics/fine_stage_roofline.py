"""Kernel C (``ops/kernels/fine_stage.py``, ``csrc/fine_stage.cu``) in the
match cells: the least time of its launches (one a forward, B x K window
pairs) over its device time."""
from bench_port.counts.kernels import fine_stage
from bench_port.metrics._common import roofline

UNIT = "%"
KERNELS = ("fine_stage_bf16", "fine_stage_kernel")


def read(ctx):
    if ctx["kind"] != "offline":
        return None
    n = ctx["launches"].get("fine_stage", 0)
    f, b = fine_stage(ctx["B"] * ctx["K"])
    return roofline(ctx, KERNELS, f * n, b * n)
