"""2-D sinusoidal position encoding (the reference's position_encoding.py).

A copy of ``loftr_tpu.models.position_encoding._pe_table``, with the
``temp_bug_fix`` flag: pre-fix checkpoints were trained with
``div_term = exp(arange(0, C//2, 2) * ((-log 1e4 / C) // 2))``.
Positions are 1-based.  Layout NHWC, channels interleaved in groups of 4:
(sin x, cos x, sin y, cos y) per frequency.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _pe_table(d_model: int, h: int, w: int, temp_bug_fix: bool) -> np.ndarray:
    """[h, w, d_model] float32 table."""
    if temp_bug_fix:
        exponent = np.arange(0, d_model // 2, 2, dtype=np.float64) * (
            -math.log(10000.0) / (d_model // 2))
    else:  # the buggy `(-log(1e4) / d_model) // 2`
        exponent = np.arange(0, d_model // 2, 2, dtype=np.float64) * (
            (-math.log(10000.0) / d_model) // 2)
    div_term = np.exp(exponent)  # [C//4]

    y_pos = np.arange(1, h + 1, dtype=np.float64)[:, None, None]
    x_pos = np.arange(1, w + 1, dtype=np.float64)[None, :, None]
    pe = np.zeros((h, w, d_model), np.float64)
    pe[:, :, 0::4] = np.sin(x_pos * div_term)
    pe[:, :, 1::4] = np.cos(x_pos * div_term)
    pe[:, :, 2::4] = np.sin(y_pos * div_term)
    pe[:, :, 3::4] = np.cos(y_pos * div_term)
    return pe.astype(np.float32)


def add_position_encoding(x: torch.Tensor, temp_bug_fix: bool = True):
    """x: [B, H, W, C] -> x + PE[:H, :W], the table cast to x's dtype."""
    _, h, w, c = x.shape
    pe = torch.from_numpy(_pe_table(c, h, w, temp_bug_fix))
    return x + pe.to(x.device, x.dtype)[None]
