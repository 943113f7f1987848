"""Milliseconds a step that the span ``train.loss`` holds the card in the
train cells (the fine supervision and the losses, kernel D's forward): its
held time over its spans (``metrics/_spans.py``)."""
from bench_port.metrics._spans import held_ms

UNIT = "ms/step"


def read(ctx):
    return held_ms(ctx, "train", "train.loss")
