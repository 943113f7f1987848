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
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] align-corners linear interpolation weights."""
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = src - lo
    w = np.zeros((n_out, n_in), np.float64)
    w[np.arange(n_out), lo] = 1.0 - frac
    w[np.arange(n_out), lo + 1] = frac
    return w.astype(np.float32)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """x: [B, C, H, W] (NCHW) -> [B, C, 2H, 2W]."""
    h, w = x.shape[-2:]
    wh = torch.from_numpy(_interp_matrix(h, 2 * h)).to(x.device, x.dtype)
    ww = torch.from_numpy(_interp_matrix(w, 2 * w)).to(x.device, x.dtype)
    x = torch.matmul(wh, x)                  # [B, C, 2H, W]
    return torch.matmul(x, ww.t())           # [B, C, 2H, 2W]
