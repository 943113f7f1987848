"""Helpers the per-layer metric readers share: kernel names, device time
and rooflines from the trace."""
from __future__ import annotations

from bench_port.counts.kernels import bound_s
from bench_port.trace import busy_s, device_seconds, kernel_base


def port_kernel(names):
    """A matcher for the port's kernels (``loftr::`` in the full name)
    whose base name is in ``names``."""
    names = frozenset(names)
    return lambda full: "loftr::" in full and kernel_base(full) in names


def roofline(ctx, kernel_names, flops, nbytes, extra_device_s=0.0):
    """Percent of the least time for ``flops`` and ``nbytes`` over the
    device time of the named kernels in the traced window; None where the
    window ran none of them."""
    t = device_seconds(ctx["trace"], port_kernel(kernel_names)) \
        + extra_device_s
    if t <= 0 or flops <= 0:
        return None
    return 100.0 * bound_s(flops, nbytes) / t


def idle(ctx, kind):
    """Percent of the traced window in which nothing ran on the card."""
    if ctx["kind"] != kind or ctx["window_s"] <= 0 or not ctx["trace"].device:
        return None
    return 100.0 * (1.0 - busy_s(ctx["trace"]) / ctx["window_s"])
