"""Bilinear x2 upsampling with align_corners=True semantics.

The two-matmul form of ``loftr_tpu.ops.interpolate.upsample2x_matmul``:
separable [2N, N] interpolation matrices, cast to the activation dtype as
the JAX package does, so bf16 results round at the same places.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def interp_taps(n_in: int, n_out: int):
    """The two taps of every output position of align-corners linear
    interpolation: (lo, hi int32 indices, w_lo, w_hi float32) [n_out]."""
    if n_in == 1:
        zero = np.zeros(n_out, np.int32)
        return (zero, zero, np.ones(n_out, np.float32),
                np.zeros(n_out, np.float32))
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = src - lo
    return (lo.astype(np.int32), (lo + 1).astype(np.int32),
            (1.0 - frac).astype(np.float32), frac.astype(np.float32))


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] align-corners linear interpolation weights."""
    lo, hi, w_lo, w_hi = interp_taps(n_in, n_out)
    w = np.zeros((n_out, n_in), np.float32)
    w[np.arange(n_out), hi] = w_hi
    w[np.arange(n_out), lo] = w_lo
    return w


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """x: [B, C, H, W] (NCHW) -> [B, C, 2H, 2W]."""
    h, w = x.shape[-2:]
    wh = torch.from_numpy(_interp_matrix(h, 2 * h)).to(x.device, x.dtype)
    ww = torch.from_numpy(_interp_matrix(w, 2 * w)).to(x.device, x.dtype)
    x = torch.matmul(wh, x)                  # [B, C, 2H, W]
    return torch.matmul(x, ww.t())           # [B, C, 2H, 2W]
