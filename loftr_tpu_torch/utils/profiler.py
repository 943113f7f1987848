"""Profiling harness (``loftr_tpu.utils.profiler``; the reference's
src/utils/profiler.py):

  - :class:`RegionProfiler` (the reference's InferenceProfiler,
    profiler.py:7-27): wall-clock region timing with a device sync at the
    region's edges (``torch.cuda.synchronize`` on a CUDA device) and a
    printable summary;
  - :func:`trace`: ``torch.profiler`` over a block, written as a Chrome
    trace (the PyTorchProfiler analogue, profiler.py:34-35);
  - :func:`span`: a ``torch.profiler.record_function`` range while a
    profiler records, else a shared no-op context; the matcher's and the
    trainer's stage spans and each :class:`RegionProfiler` region are
    spans, so their ops group in traces and a run with no profiler pays
    one flag check a span.

The port runs one process until the parallel modules land, so the profiler
is always that of rank 0.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


_NO_SPAN = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` while a
    ``torch.profiler`` records (host range and its device-side shadow in
    the trace), else one shared no-op context.  Never synchronises."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def hard_sync() -> None:
    """Wait for the CUDA device's queued work (a no-op without CUDA)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class RegionProfiler:
    """Named-region wall timing with device sync at region edges."""

    def __init__(self, enabled: bool = True, sync: bool = True):
        self.enabled = enabled
        self.sync = sync
        self.times: Dict[str, list] = defaultdict(list)

    def profile(self, name: str):
        """A context timing region ``name``; disabled, just its span."""
        return self._timed(name) if self.enabled else span(name)

    @contextlib.contextmanager
    def _timed(self, name: str):
        if self.sync:
            hard_sync()
        t0 = time.perf_counter()
        with span(name):
            yield
        if self.sync:
            hard_sync()
        self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = [f"{'region':<32} {'calls':>6} {'mean ms':>10} {'total s':>9}"]
        for name, ts in sorted(self.times.items()):
            lines.append(f"{name:<32} {len(ts):>6} "
                         f"{1000 * sum(ts) / len(ts):>10.2f} "
                         f"{sum(ts):>9.2f}")
        return "\n".join(lines)

    def totals(self) -> Dict[str, dict]:
        """{region: {"calls", "total_s", "mean_ms"}}."""
        return {name: {"calls": len(ts), "total_s": sum(ts),
                       "mean_ms": 1000 * sum(ts) / len(ts)}
                for name, ts in sorted(self.times.items())}


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (CPU, and CUDA when present),
    written to ``{logdir}/trace.json`` (open in Perfetto or
    chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def build_profiler(name: Optional[str] = None) -> RegionProfiler:
    """Factory mirroring build_profiler (profiler.py:30-39)."""
    if name == "inference":
        return RegionProfiler(enabled=True, sync=True)
    if name is None:
        return RegionProfiler(enabled=False)
    raise ValueError(f"unknown profiler {name!r} (use 'inference' or the "
                     "trace() context manager for a full torch.profiler "
                     "trace)")
