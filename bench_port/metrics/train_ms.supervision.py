"""Milliseconds a step that the span ``train.supervision`` holds the card in
the train cells (the coarse supervision): its held time over its spans
(``metrics/_spans.py``)."""
from bench_port.metrics._spans import held_ms

UNIT = "ms/step"


def read(ctx):
    return held_ms(ctx, "train", "train.supervision")
