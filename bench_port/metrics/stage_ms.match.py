"""Milliseconds a pair that the span ``loftr.match`` holds the card in the
match cells (coarse matching and top-K, kernel B or E): its held time over
its spans and the pairs of a forward (``metrics/_spans.py``)."""
from bench_port.metrics._spans import held_ms

UNIT = "ms/pair"


def read(ctx):
    return held_ms(ctx, "offline", "loftr.match", ctx["B"])
