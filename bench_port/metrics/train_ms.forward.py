"""Milliseconds a step that the span ``train.forward`` holds the card in the
train cells (the training forward): its held time over its spans
(``metrics/_spans.py``). It is read between the device end of
``train.supervision`` and the device start of ``train.loss``, since the
``loftr.*`` spans inside it take their own launches."""
from bench_port.metrics._spans import held_ms

UNIT = "ms/step"


def read(ctx):
    return held_ms(ctx, "train", "train.forward")
