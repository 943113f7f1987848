"""Device time held by the port's stage spans, for the ``stage_ms.*`` and
``train_ms.*`` readers.

The port runs its stages inside ``utils/profiler.span`` ranges: the four
``loftr.*`` spans of ``models/matcher.py::LoFTR`` (``extract``, ``coarse``,
``match``, ``fine``) and the six ``train.*`` spans of
``Trainer.train_step``.  Under the profiler each such host range has a
shadow on the device timeline, from the start of the first device activity
launched inside it to the end of the last.  A stage's held time is the
length of the union of its shadows in the traced window: its kernels and
copies, and the card's idle between them, the time the stage holds the
card.  A reader divides it by the stage's host spans in the window (and,
for a match cell, by the pairs of a forward).

The profiler gives a device launch to the innermost range of the thread
that launched it, so two training stages are read by another rule.
``train.forward`` holds the ``loftr.*`` spans, and its own shadow covers
only what it launches outside them (from the coarse keypoints to the fine
ones).  The autograd engine launches ``train.backward``'s kernels from its
own thread, so that range's shadow holds only the zero fill.  One stream
runs a step's stages in order, so each of the two is taken between its
neighbours: the forward from the device end of the step's
``train.supervision`` to the device start of its ``train.loss``, the
backward from the device end of ``train.loss`` to the device start of
``train.update``.

The harness's ``trace.collect`` drops the shadows (it keeps device
activity and host events only), so they are read here from the finished
``torch.profiler.profile`` that the run still holds while its readers
read.  A program without the spans (an older port) gives none, and every
reader returns None.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

from bench_port.trace import WINDOW, union

MATCH = ("loftr.extract", "loftr.coarse", "loftr.match", "loftr.fine")
TRAIN = ("train.upload", "train.supervision", "train.forward",
         "train.loss", "train.backward", "train.update")
STAGES = MATCH + TRAIN


def _held_profile():
    """The ``torch.profiler.profile`` a caller up the stack holds (the
    run's ``measure``, between the window and its readers), or None."""
    from torch.profiler import profile
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, profile):
                return v
        f = f.f_back
    return None


def collect_shadows(prof) -> List[Tuple[str, float, float]]:
    """The device-side shadows of the stage spans in ``prof``: (name,
    start, end) in seconds from the start of the ``WINDOW`` span (the
    readers clip them to the window)."""
    t0 = None
    raw = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name == WINDOW:
            if not str(e.device_type()).endswith("CUDA"):
                t0 = e.start_ns()
        elif name in STAGES and e.is_user_annotation() and \
                str(e.device_type()).endswith("CUDA"):
            raw.append((name, e.start_ns(), e.end_ns()))
    if t0 is None:
        return []
    return [(n, (s - t0) * 1e-9, (e - t0) * 1e-9) for n, s, e in raw]


def shadows(ctx) -> List[Tuple[str, float, float]]:
    """The run's stage shadows, read once and kept in ``ctx`` (a test puts
    its own under ``"spans"``)."""
    if "spans" not in ctx:
        prof = _held_profile()
        ctx["spans"] = [] if prof is None else collect_shadows(prof)
    return ctx["spans"]


# stage: (the stage before it, the stage after it) on the device
BETWEEN = {"train.forward": ("train.supervision", "train.loss"),
           "train.backward": ("train.loss", "train.update")}


def between(spans, before: str, after: str) -> List[Tuple[float, float]]:
    """For each shadow of ``before``, the interval from its end to the
    start of the first shadow of ``after`` that follows it (none where
    another ``before`` comes first: a step cut by the trace's edge)."""
    seq = sorted((s, e, n) for n, s, e in spans if n in (before, after))
    return [(e, s2) for (_, e, n), (s2, _, n2) in zip(seq, seq[1:])
            if n == before and n2 == after and s2 >= e]


def intervals(ctx) -> Dict[str, List[Tuple[float, float]]]:
    """{stage: its device-side intervals}, relative to the window."""
    spans = shadows(ctx)
    out: Dict[str, List[Tuple[float, float]]] = {n: [] for n in STAGES}
    for n, s, e in spans:
        out[n].append((s, e))
    for n, (before, after) in BETWEEN.items():
        out[n] = between(spans, before, after)
    return out


def held_ms(ctx, kind: str, stage: str, per: int = 1) -> Optional[float]:
    """Milliseconds of the window that ``stage`` holds the card, over its
    host spans in the window and ``per``; None in a cell of another kind
    or where the window shows no such span."""
    if ctx["kind"] != kind:
        return None
    hosts = sum(1 for n, _, _ in ctx["trace"].host if n == stage)
    iv = union(intervals(ctx)[stage], 0.0, ctx["window_s"])
    held = sum(e - s for s, e in iv)
    if not hosts or held <= 0:
        return None
    return 1e3 * held / hosts / per
