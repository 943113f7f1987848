"""Share of the traced window in which nothing ran on the card (the union
of every kernel, copy and set on all streams) in the train cells."""
from bench_port.metrics._common import idle

UNIT = "%"


def read(ctx):
    return idle(ctx, "train")
