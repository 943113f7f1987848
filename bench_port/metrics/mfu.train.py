"""The training cell's whole-step share of the card's bf16 peak: three
times the analytic forward FLOPs of a pair (forward and backward) at the
training selection's K windows, times the traced window's pairs a second,
over 989 TFLOP/s."""
from bench_port.counts.kernels import PEAK_BF16_FLOPS
from bench_port.counts.model_flops import pair_forward

UNIT = "%"


def read(ctx):
    if ctx["kind"] != "train" or ctx["rate"] <= 0:
        return None
    return 100.0 * 3 * pair_forward(ctx["H"], ctx["W"], ctx["K"]) \
        * ctx["rate"] / PEAK_BF16_FLOPS
