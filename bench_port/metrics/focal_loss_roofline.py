"""Kernel D (``ops/kernels/focal_loss.py``, ``csrc/focal_loss.cu``) in the
training cell: the 5-product least time of each forward and backward over
the device time of its kernels, with half of kernel B's first pass and its
combine (the loss takes the statistics pass alone; the matcher's candidate
pass runs the same kernels once more a step)."""
from bench_port.counts.kernels import focal_loss
from bench_port.metrics._common import port_kernel, roofline
from bench_port.trace import device_seconds

UNIT = "%"
KERNELS = ("focal_prescale", "focal_loss_bf16", "loss_combine",
           "focal_grad_bf16", "grad_combine", "focal_tile_kernel",
           "focal_grad_kernel", "sum_combine_kernel",
           "scalar_combine_kernel")


def _stats_pass(full):
    return ("loftr::" in full and "dual_softmax_bf16<" in full
            and full.split(">")[0].rstrip().endswith(", 0")) or \
        port_kernel(("stats_combine",))(full)


def read(ctx):
    if ctx["kind"] != "train":
        return None
    n = ctx["launches"].get("focal_loss_backward", 0)
    f, b = focal_loss(ctx["B"], ctx["L"], ctx["S"])
    half_b = 0.5 * device_seconds(ctx["trace"], _stats_pass)
    return roofline(ctx, KERNELS, f * n, b * n, half_b)
