"""Milliseconds a step that the span ``train.backward`` holds the card in the
train cells (the gradients, kernel D's backward): its held time over its
spans (``metrics/_spans.py``). It is read between the device end of
``train.loss`` and the device start of ``train.update``, since the autograd
engine launches from its own thread."""
from bench_port.metrics._spans import held_ms

UNIT = "ms/step"


def read(ctx):
    return held_ms(ctx, "train", "train.backward")
