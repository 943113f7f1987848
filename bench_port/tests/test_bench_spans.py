"""The stage readers (``metrics/stage_ms.*``, ``metrics/train_ms.*``) on
stub profiler events and synthetic traces: the shadows of the port's stage
spans read beside an unchanged ``trace.collect``, each stage's held time
over its spans, the neighbour rule of ``train.forward`` and
``train.backward``, and None in cells of the other kind or from a program
without the spans."""
from types import SimpleNamespace

import pytest
from torch.profiler import profile

from bench_port import core, trace
from bench_port.metrics import _spans

READERS = core.metric_readers()
MATCH = ["stage_ms.extract", "stage_ms.coarse", "stage_ms.match",
         "stage_ms.fine"]
TRAIN = ["train_ms.upload", "train_ms.supervision", "train_ms.forward",
         "train_ms.loss", "train_ms.backward", "train_ms.update"]


class Ev:
    """A kineto event as ``collect`` reads it (times in ns)."""

    def __init__(self, name, start, end, cuda=False, annotation=False):
        self._n, self._s, self._e = name, start, end
        self._cuda, self._ann = cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return "DeviceType.CUDA" if self._cuda else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._ann


class Held(profile):
    """A finished profile holding ``events`` (no profiler behind it)."""

    def __init__(self, events):
        self.profiler = SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events))


T0 = 5_000_000_000      # the window starts 5 s into the profiler's clock
MS = 1_000_000


def _events():
    """A window of 10 ms: one forward's extract on the host in [1, 3] ms
    launching kA, whose device shadow is [2, 4] ms."""
    return [
        Ev(trace.WINDOW, T0, T0 + 10 * MS, annotation=True),
        Ev(trace.WINDOW, T0 + 2 * MS, T0 + 9 * MS, cuda=True,
           annotation=True),
        Ev("loftr.extract", T0 + 1 * MS, T0 + 3 * MS, annotation=True),
        Ev("aten::conv2d", T0 + 1 * MS, T0 + 2 * MS),
        Ev("cudaLaunchKernel", T0 + 1 * MS, T0 + 1 * MS + 10),
        Ev("loftr.extract", T0 + 2 * MS, T0 + 4 * MS, cuda=True,
           annotation=True),
        Ev("kA", T0 + 2 * MS, T0 + 4 * MS, cuda=True),
        Ev("kB", T0 + 11 * MS, T0 + 12 * MS, cuda=True),   # after it
    ]


def test_collect_is_unchanged_and_the_shadows_are_read_beside_it():
    prof = Held(_events())
    tr = trace.collect(prof)
    ms = lambda a, b: (pytest.approx(a * 1e-3), pytest.approx(b * 1e-3))
    assert [(n, *ms(s * 1e3, e * 1e3)) for n, s, e in tr.device] == \
        [("kA", *ms(2, 4))]
    assert [n for n, _, _ in tr.host] == ["loftr.extract", "aten::conv2d",
                                          "cudaLaunchKernel"]
    assert tr.window_s == pytest.approx(0.01)
    got = _spans.collect_shadows(prof)
    assert [(n, *ms(s * 1e3, e * 1e3)) for n, s, e in got] == \
        [("loftr.extract", *ms(2, 4))]


def test_a_reader_finds_the_profile_its_run_holds():
    prof = Held(_events())          # as run.measure holds it  # noqa: F841
    tr = trace.collect(prof)
    ctx = {"kind": "offline", "trace": tr, "window_s": tr.window_s, "B": 2}
    assert READERS["stage_ms.extract"].read(ctx) == pytest.approx(1.0)
    assert READERS["stage_ms.fine"].read(ctx) is None


def _match_ctx(B=4):
    """Two forwards in a 1 s window; the device runs forward 1's stages in
    [0.10, 0.40] and forward 2's in [0.45, 0.80], with idle inside."""
    host, spans = [], []
    for k, t in enumerate((0.0, 0.4)):
        for j, stage in enumerate(_spans.MATCH):
            host.append((stage, t + 0.05 * j, t + 0.05 * (j + 1)))
    spans = [("loftr.extract", 0.10, 0.20), ("loftr.coarse", 0.20, 0.30),
             ("loftr.match", 0.30, 0.32), ("loftr.fine", 0.32, 0.40),
             ("loftr.extract", 0.45, 0.60), ("loftr.coarse", 0.60, 0.66),
             ("loftr.match", 0.66, 0.70), ("loftr.fine", 0.70, 0.80)]
    dev = [("k", 0.10, 0.40), ("k", 0.45, 0.80)]
    return {"kind": "offline", "trace": trace.Trace(1.0, dev, host),
            "window_s": 1.0, "B": B, "spans": spans}


def test_match_stages_are_their_held_time_over_spans_and_pairs():
    ctx = _match_ctx(B=4)
    want = {"stage_ms.extract": (0.10 + 0.15), "stage_ms.coarse": 0.16,
            "stage_ms.match": 0.06, "stage_ms.fine": 0.18}
    for name, held_s in want.items():
        assert READERS[name].read(ctx) == pytest.approx(
            1e3 * held_s / 2 / 4), name
    assert all(READERS[n].read(ctx) is None for n in TRAIN)


def _train_ctx(tail=True):
    """Two steps; the backward's own shadow is its zero fill alone and the
    forward's covers only its last launches (the loftr.* spans take the
    rest).  With ``tail`` False the window ends before the second step's
    update reaches the card."""
    host, spans = [], []
    for t in (0.0, 1.0):
        host += [(s, t + 0.01 * j, t + 0.01 * (j + 1))
                 for j, s in enumerate(_spans.TRAIN + _spans.MATCH)]
        spans += [("train.upload", t + 0.00, t + 0.02),
                  ("train.supervision", t + 0.02, t + 0.05),
                  ("loftr.extract", t + 0.06, t + 0.20),
                  ("loftr.coarse", t + 0.20, t + 0.25),
                  ("loftr.match", t + 0.25, t + 0.26),
                  ("loftr.fine", t + 0.27, t + 0.30),
                  ("train.forward", t + 0.26, t + 0.31),
                  ("train.loss", t + 0.31, t + 0.35),
                  ("train.backward", t + 0.36, t + 0.361),
                  ("train.update", t + 0.80, t + 0.85)]
    if not tail:
        spans = spans[:-1]
    dev = [("k", 0.0, 0.9), ("k", 1.0, 1.9)]
    return {"kind": "train", "trace": trace.Trace(2.0, dev, host),
            "window_s": 2.0, "B": 4, "spans": spans}


def test_train_stages_and_the_neighbour_rule():
    ctx = _train_ctx()
    want = {"train_ms.upload": 0.02, "train_ms.supervision": 0.03,
            "train_ms.forward": 0.31 - 0.05,    # supervision .. loss
            "train_ms.loss": 0.04,
            "train_ms.backward": 0.80 - 0.35,   # loss .. update
            "train_ms.update": 0.05}
    for name, held_s in want.items():
        assert READERS[name].read(ctx) == pytest.approx(1e3 * held_s), name
    assert all(READERS[n].read(ctx) is None for n in MATCH)


def test_a_step_cut_by_the_window_gives_no_backward_interval():
    cut = _spans.intervals(_train_ctx(tail=False))["train.backward"]
    assert cut == [(pytest.approx(0.35), pytest.approx(0.80))]


def test_a_program_without_spans_gives_no_stage_metric():
    for ctx in (_match_ctx(), _train_ctx()):
        ctx["spans"] = []
        assert all(READERS[n].read(ctx) is None for n in MATCH + TRAIN)
    prof = Held([e for e in _events() if not e.name().startswith("loftr.")])
    assert _spans.collect_shadows(prof) == []
