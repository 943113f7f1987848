"""Kernel E (``ops/kernels/sinkhorn.py``, ``csrc/sinkhorn.cu``) in the OT
match cells: the least time of its launches (one a forward: the Sinkhorn
iterations, the final pass and, with ``prefilter``, the filtered pass)
over the device time of its passes and combines.  None in a cell whose
window launched no Sinkhorn kernel (the dual-softmax cells)."""
from bench_port.counts.sinkhorn import sinkhorn
from bench_port.metrics._common import roofline

UNIT = "%"
KERNELS = ("sinkhorn_bf16", "ot_tile_kernel", "bin_kernel",
           "u_combine_kernel", "v_combine_kernel", "row_best_kernel",
           "col_best_kernel")


def read(ctx):
    n = ctx["launches"].get("sinkhorn", 0)
    if ctx["kind"] != "offline" or n <= 0:
        return None
    inf = ctx["cfg"]["inference"]
    f, b = sinkhorn(ctx["B"], ctx["L"], ctx["S"],
                    iters=inf.get("skh_iters", 3),
                    prefilter=inf.get("skh_prefilter", False))
    return roofline(ctx, KERNELS, f * n, b * n)
