"""Milliseconds a pair that the span ``loftr.extract`` holds the card in the
match cells (the backbone, position encoding and flatten): its held time
over its spans and the pairs of a forward (``metrics/_spans.py``)."""
from bench_port.metrics._spans import held_ms

UNIT = "ms/pair"


def read(ctx):
    return held_ms(ctx, "offline", "loftr.extract", ctx["B"])
