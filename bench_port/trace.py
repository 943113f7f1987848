"""The traced run: ``torch.profiler`` over the measured window, reduced to
device intervals, busy and idle time, and a breakdown.

Device activity is every kernel, copy and set on any stream of the card.
Busy time is the length of the union of their intervals (streams overlap,
so a plain sum would count twice); idle time is the window less that.  An
idle gap is labelled by what the host was doing: the innermost host event
(a span of the benchmark, an operator, a runtime call) whose interval
covers the gap's midpoint; the many short gaps between launches are
summed apart.
"""
from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple


@dataclass
class Trace:
    """Events of one traced window, times in seconds from its start."""
    window_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)


def kernel_base(name: str) -> str:
    """``void loftr::(anonymous namespace)::bf::dual_softmax_bf16<2, 4, 3,
    0>(...)`` -> ``dual_softmax_bf16``; other names lose their arguments,
    templates and namespaces alike."""
    s = name.replace("(anonymous namespace)::", "").replace("void ", "")
    s = s.split("(")[0]
    s = re.sub(r"<.*", "", s)
    return s.split("::")[-1].strip() or name


WINDOW = "bench.window"


def collect(prof) -> Trace:
    """Device and host events of a finished ``torch.profiler.profile``
    inside the host span named ``WINDOW`` (the measured window; the
    profiler's clock is its own, so the window is read from the trace)."""
    raw = []
    bounds = None
    for e in prof.profiler.kineto_results.events():
        dur = e.duration_ns()
        if dur <= 0:
            continue
        start = e.start_ns()
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device and e.is_user_annotation():
            continue    # a host span's shadow on the device timeline
        if e.name() == WINDOW and not on_device:
            bounds = (start, start + dur)
        raw.append((e.name(), start, start + dur, on_device))
    if bounds is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    t0, t1 = bounds
    tr = Trace((t1 - t0) * 1e-9)
    for name, s, e, on_device in raw:
        if e <= t0 or s >= t1 or name == WINDOW:
            continue
        ev = (name, (s - t0) * 1e-9, (e - t0) * 1e-9)
        (tr.device if on_device else tr.host).append(ev)
    return tr


def union(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """Merged intervals, clipped to [lo, hi]."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(tr: Trace) -> float:
    return sum(e - s for s, e in union([(s, e) for _, s, e in tr.device],
                                       0.0, tr.window_s))


def idle_gaps(tr: Trace) -> List[Tuple[float, float]]:
    """The intervals of the window in which nothing ran on the device."""
    merged = union([(s, e) for _, s, e in tr.device], 0.0, tr.window_s)
    gaps, t = [], 0.0
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = e
    if t < tr.window_s:
        gaps.append((t, tr.window_s))
    return gaps


def device_seconds(tr: Trace, match) -> float:
    """Summed duration of the device events whose name ``match`` accepts
    (a callable on the full name)."""
    return sum(e - s for n, s, e in tr.device if match(n))


def top_ops(tr: Trace, n: int = 10) -> List[list]:
    per: Dict[str, float] = {}
    for name, s, e in tr.device:
        k = kernel_base(name)
        per[k] = per.get(k, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]


def gaps_by_host(tr: Trace, n: int = 10, short_s: float = 1e-4
                 ) -> List[list]:
    """Idle seconds grouped by the innermost host event at each gap's
    midpoint ("no host event" where none covers it); gaps shorter than
    ``short_s`` (launch spacing) are summed under one label."""
    host = sorted(tr.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    short = f"gaps under {short_s * 1e3:g} ms"
    per: Dict[str, float] = {}
    for gs, ge in idle_gaps(tr):
        label = short
        if ge - gs >= short_s:
            mid = 0.5 * (gs + ge)
            label = "no host event"
            i = bisect.bisect_right(starts, mid)
            # the latest-starting host event that still covers mid
            for j in range(i - 1, max(-1, i - 500), -1):
                if host[j][2] >= mid:
                    label = host[j][0]
                    break
        per[label] = per.get(label, 0.0) + (ge - gs)
    return [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(tr: Trace) -> dict:
    return {"device_ops": top_ops(tr), "idle_gaps": gaps_by_host(tr)}
