"""The OT match cells' whole-step share of the card's bf16 peak: the
analytic forward FLOPs of a LoFTR-OT pair at the published widths
(``counts/sinkhorn.pair_forward_ot``: ``pair_forward`` and one [L, S]
product more a Sinkhorn iteration) times the traced window's pairs a
second, over 989 TFLOP/s.  None outside an OT configuration."""
from bench_port.counts.kernels import PEAK_BF16_FLOPS
from bench_port.counts.sinkhorn import pair_forward_ot

UNIT = "%"


def read(ctx):
    inf = ctx["cfg"].get("inference", {})
    if ctx["kind"] != "offline" or ctx["rate"] <= 0 \
            or "skh_iters" not in inf:
        return None
    return 100.0 * pair_forward_ot(ctx["H"], ctx["W"], ctx["K"],
                                   inf["skh_iters"]) \
        * ctx["rate"] / PEAK_BF16_FLOPS
