"""Kernel G: x2 align-corners bilinear upsample of NCHW maps.

Replaces ``loftr_tpu/ops/pallas/upsample.py::upsample2x_pallas``
(``_upsample_kernel``).  CUDA source: ``csrc/upsample.cu``.

The same function as ``ops.interpolate.upsample2x_align_corners`` (its
plain version: the H pass, then the W pass, two-tap weights cast to the
activation dtype, float32 accumulation, the intermediate rounded to the
dtype), as one gather pass: every output element reads its 2 x 2 taps, and
the interpolation matrices with their zero products are never formed.

What bounds it on the H100: bytes, the input once and four times as many
output values.  In bf16 a block takes one map's band of 64 output rows
through shared memory and writes 16 bytes a thread; float32 (and rows over
1176 wide) take one pass over the output rows (the source's header note).

``upsample2x`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors only; inference only (no gradient on the CUDA
path).  ``upsample2x.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from loftr_tpu_torch.ops.interpolate import (interp_taps,
                                             upsample2x_align_corners)
from loftr_tpu_torch.ops.kernels import _build

upsample2x_plain = upsample2x_align_corners


@functools.lru_cache(maxsize=64)
def _tap_tables(n_in: int, dtype: torch.dtype, device: torch.device):
    """(lo, hi int32, w_lo, w_hi float32 rounded to dtype) [2 * n_in] on
    the device."""
    lo, hi, w_lo, w_hi = interp_taps(n_in, 2 * n_in)
    rounded = [torch.from_numpy(w).to(dtype).float() for w in (w_lo, w_hi)]
    return tuple(t.to(device).contiguous() for t in (
        torch.from_numpy(lo), torch.from_numpy(hi), *rounded))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """x: [B, C, H, W] (NCHW), float32 or bfloat16 -> [B, C, 2H, 2W]."""
    if _build.runs_plain("upsample kernel", x):
        return upsample2x_plain(x)
    if x.dim() != 4:
        raise ValueError(f"upsample kernel takes [B, C, H, W], got {x.shape}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("the upsample kernel is inference only")
    x = x.contiguous()
    b, c, h, w = x.shape
    code = _build.dtype_code(x)
    lib = _build.library()
    ty = _tap_tables(h, x.dtype, x.device)
    tx = _tap_tables(w, x.dtype, x.device)
    out = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    p = ctypes.c_void_p
    err = lib.loftr_upsample2x(
        p(x.data_ptr()), *[p(t.data_ptr()) for t in ty],
        *[p(t.data_ptr()) for t in tx], p(out.data_ptr()), b * c, h, w, code,
        p(_build.stream_ptr(x)))
    _build.check(err, "loftr_upsample2x")
    upsample2x.launches += 1
    return out


upsample2x.launches = 0
