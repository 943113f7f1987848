"""Operations and bytes of the port's kernels A-D at a call's shapes, and
the H100's peaks: the least time a call could take.

Copied from ``chip_smoke.py`` (kernel A :610-615, B :681-682, C :739-740,
D ``focal_bounds`` :1211), which counts the work of the function at the
call's shapes, whatever design computes it.  A bound is the larger of the
operations over the bf16 tensor-core peak and the bytes over the memory
bandwidth (``bound_s``).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """Seconds at the peak: operations or bytes, whichever takes longer."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def coarse_layer(x_rows: int, src_rows: int, C: int = 256):
    """Kernel A, one encoder layer: per x row q, merge and the FFN (8 C^2
    multiply-adds) and the per-head KV apply and normaliser; per source
    row k, v (2 C^2) and the per-head KV blocks.  Bytes: x, src and the
    output once each, the bf16 weights once."""
    flops = 2 * (x_rows * (8 * C * C + C * (C // 8) + C)
                 + src_rows * (2 * C * C + C * (C // 8)))
    nbytes = 2 * x_rows * C * 2 + x_rows * C * 2 + 10 * C * C * 2 + 4 * C * 4
    return flops, nbytes


def coarse_stack_forward(B: int, L: int, S: int, C: int = 256,
                         n_layers: int = 8):
    """Kernel A's launches of one forward of B pairs: each 'self' layer
    once on both images packed (2B x L rows), each 'cross' layer once a
    direction (B x L, then B x S rows).  Returns (flops, bytes, launches)."""
    f = b = 0
    for _ in range(n_layers // 2):
        for x, s in ((B * (L + S), B * (L + S)), (B * L, B * S),
                     (B * S, B * L)):
            ff, bb = coarse_layer(x, s, C)
            f, b = f + ff, b + bb
    return f, b, 3 * (n_layers // 2)


def dual_softmax(B: int, L: int, S: int, C: int = 256):
    """Kernel B: two [L, S] x C products (statistics, best); features in,
    the best value and index a row and the column maxima out."""
    return 2 * 2 * B * L * S * C, B * (2 * L * C * 2 + L * 8 + L * 4)


def fine_stage(NB: int, Cf: int = 128, WW: int = 25):
    """Kernel C on NB window pairs: 4 encoder applications x WW rows of
    10 Cf^2 multiply-adds, plus the score-form attention (WW scores and WW
    taps a row); the windows in, (x, y, std) out, the weights once."""
    flops = NB * (2 * 4 * WW * 10 * Cf * Cf + 2 * 2 * 4 * WW * WW * Cf)
    nbytes = 2 * NB * WW * Cf * 2 + NB * 3 * 4 + 2 * 10 * Cf * Cf * 2
    return flops, nbytes


def focal_loss(B: int, L: int, S: int, C: int = 256):
    """Kernel D, forward and backward: the 5 products of 2 L S C that the
    function needs (the statistics' and the loss's sim; the backward's
    sim and its two gradient products); bytes: both feature maps in, both
    gradients out, in bf16."""
    return 5 * 2.0 * B * L * S * C, B * 2 * (L + S) * C * 2
