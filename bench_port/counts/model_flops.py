"""Analytic forward FLOPs of one LoFTR pair at the published widths.

The count of ``tools/flops_analysis.py`` (759 GFLOP a pair for
``indoor_ds`` at 640x480), rewritten in plain Python: every convolution
and matrix product of the (8, 2) ResNet-FPN, the align-corners upsamples
as two dense products, the coarse encoder layers, the [L, S] similarity
and the fine stage at K windows.  Widths are the published ones (196
channels in the middle stage, not the port's padded 256): the useful work.
"""
from __future__ import annotations


def conv(h: int, w: int, cin: int, cout: int, k: int, stride: int = 1):
    return (h // stride) * (w // stride) * k * k * cin * cout * 2


def backbone(H: int, W: int, c0: int = 128, dims=(128, 196, 256)) -> int:
    """One image."""
    d0, d1, d2 = dims
    h2, w2, h4, w4, h8, w8 = H // 2, W // 2, H // 4, W // 4, H // 8, W // 8
    return (conv(H, W, 1, c0, 7, 2)
            + 4 * conv(h2, w2, d0, d0, 3)
            + conv(h2, w2, d0, d1, 3, 2) + conv(h2, w2, d0, d1, 1, 2)
            + 3 * conv(h4, w4, d1, d1, 3)
            + conv(h4, w4, d1, d2, 3, 2) + conv(h4, w4, d1, d2, 1, 2)
            + 3 * conv(h8, w8, d2, d2, 3)
            + conv(h8, w8, d2, d2, 1)
            + (h4 * h8 * w8 * d2 + h4 * w4 * w8 * d2) * 2
            + conv(h4, w4, d1, d2, 1) + conv(h4, w4, d2, d2, 3)
            + conv(h4, w4, d2, d1, 3)
            + (h2 * h4 * w4 * d1 + h2 * w2 * w4 * d1) * 2
            + conv(h2, w2, d0, d1, 1) + conv(h2, w2, d1, d1, 3)
            + conv(h2, w2, d1, d0, 3))


def encoder_layer(L: int, S: int, d: int, nhead: int) -> int:
    """One linear-attention encoder layer call: Q/K/V, the attention
    products, the merge and the concat FFN (2d -> 2d -> d)."""
    dh = d // nhead
    return ((L + 2 * S) * d * d * 2 + (S + L) * d * dh * 2 + L * d * d * 2
            + L * (2 * d) * (2 * d) * 2 + L * (2 * d) * d * 2)


def pair_forward(H: int, W: int, K: int, d_coarse: int = 256,
                 coarse_layers: int = 8, d_fine: int = 128,
                 fine_layers: int = 2, nhead: int = 8, window: int = 5,
                 c0: int = 128, dims=(128, 196, 256)) -> int:
    """Forward FLOPs of one pair of H x W images with K fine windows."""
    L = (H // 8) * (W // 8)
    ww = window * window
    return (2 * backbone(H, W, c0, dims)
            + coarse_layers * 2 * encoder_layer(L, L, d_coarse, nhead)
            + L * L * d_coarse * 2
            + fine_layers * 2 * encoder_layer(ww, ww, d_fine, nhead) * K
            + K * ww * d_fine * 2)
