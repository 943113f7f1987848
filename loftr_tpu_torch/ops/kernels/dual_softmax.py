"""Kernel B: dual-softmax + mutual-nearest statistics, no [L, S] matrix.

Replaces ``loftr_tpu/ops/pallas/dual_softmax.py::_fused_dual_softmax_core``
(``_stats_kernel`` and ``_best_kernel``).  CUDA source:
``csrc/dual_softmax.cu``.

What bounds it on the H100: operations, 2 x 2*L*S*C flop (the sim tiles
are computed twice) plus about 4*L*S exponentials, against (L+S)*C input
values.  The kernel recomputes 64x64 sim tiles in each pass instead of
storing the 92 MB [L, S] matrix of a 640x480 pair.  Blocks own a row tile
and a chunk of columns, so row and column statistics come out as partials
that small kernels combine in a fixed order (log-sum-exp for the softmax
statistics, max with the lowest index on ties for the row best).

``fused_dual_softmax_match`` launches the kernel for CUDA tensors and runs
:func:`dual_softmax_plain` (which materialises sim and conf) for CPU tensors
only.  ``fused_dual_softmax_match.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from loftr_tpu_torch.ops.kernels import _build

NEG = -1e9
TILE = 64          # row and column tile of csrc/dual_softmax.cu
TARGET_BLOCKS = 4 * 132  # enough blocks to fill an H100's 132 SMs


def _mask_vectors(B, L, S, mask0, mask1, device):
    m0 = (torch.ones((B, L), dtype=torch.float32, device=device)
          if mask0 is None else mask0.reshape(B, L).float().contiguous())
    m1 = (torch.ones((B, S), dtype=torch.float32, device=device)
          if mask1 is None else mask1.reshape(B, S).float().contiguous())
    return m0, m1


def dual_softmax_plain(feat0: torch.Tensor, feat1: torch.Tensor,
                       temperature: float = 0.1,
                       mask0: Optional[torch.Tensor] = None,
                       mask1: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (materialises [B, L, S])."""
    B, L, C = feat0.shape
    S = feat1.shape[1]
    scale = 1.0 / (C * float(temperature))
    m0, m1 = _mask_vectors(B, L, S, mask0, mask1, feat0.device)
    sim = torch.matmul(feat0.float(), feat1.float().transpose(1, 2)) * scale
    sim = sim + (m0[:, :, None] * m1[:, None, :] - 1.0) * (-NEG)
    rmax = sim.amax(dim=2, keepdim=True)
    rsum = torch.exp(sim - rmax).sum(dim=2, keepdim=True)
    cmax = sim.amax(dim=1, keepdim=True)
    csum = torch.exp(sim - cmax).sum(dim=1, keepdim=True)
    conf = torch.exp(sim - rmax) / rsum * (torch.exp(sim - cmax) / csum)
    best_val = conf.amax(dim=2)
    best_j = conf.argmax(dim=2)  # first maximum, as jnp.argmax
    return best_val, best_j.to(torch.int32), conf.amax(dim=1)


def _chunk_tiles(B: int, L: int, S: int) -> int:
    """Column tiles per block: split S so the grid fills the card."""
    nrt = math.ceil(L / TILE)
    nct = math.ceil(S / TILE)
    nch = max(1, min(nct, math.ceil(TARGET_BLOCKS / (nrt * B))))
    return math.ceil(nct / nch)


def fused_dual_softmax_match(feat0: torch.Tensor, feat1: torch.Tensor,
                             temperature: float = 0.1,
                             mask0: Optional[torch.Tensor] = None,
                             mask1: Optional[torch.Tensor] = None):
    """feat0: [B, L, C], feat1: [B, S, C] (raw transformer outputs; the
    1/(C*T) scaling is applied to the float dot here).  mask0 [B, L] /
    mask1 [B, S] optional.  Returns (best_val [B, L] float32, best_j [B, L]
    int32, colconf [B, S] float32)."""
    if not feat0.is_cuda:
        return dual_softmax_plain(feat0, feat1, temperature, mask0, mask1)
    B, L, C = feat0.shape
    S = feat1.shape[1]
    if feat1.shape[0] != B or feat1.shape[2] != C or feat1.dtype != feat0.dtype:
        raise ValueError("feat0 and feat1 must share batch, width and dtype")
    if not (feat0.is_contiguous() and feat1.is_contiguous()):
        raise ValueError("dual-softmax kernel takes contiguous features")
    code = _build.dtype_code(feat0)
    lib = _build.library()
    m0, m1 = _mask_vectors(B, L, S, mask0, mask1, feat0.device)
    ct = _chunk_tiles(B, L, S)
    nrt = math.ceil(L / TILE)
    nch = math.ceil(math.ceil(S / TILE) / ct)
    dev = feat0.device
    f32 = dict(dtype=torch.float32, device=dev)
    row_pa = torch.empty((B, nch, L), **f32)
    row_pb = torch.empty((B, nch, L), **f32)   # sumexp, then int32 argmax
    col_pa = torch.empty((B, nrt, S), **f32)
    col_pb = torch.empty((B, nrt, S), **f32)
    rmax = torch.empty((B, L), **f32)
    rsum = torch.empty((B, L), **f32)
    cmax = torch.empty((B, S), **f32)
    csum = torch.empty((B, S), **f32)
    best_val = torch.empty((B, L), **f32)
    best_j = torch.empty((B, L), dtype=torch.int32, device=dev)
    colconf = torch.empty((B, S), **f32)
    p = ctypes.c_void_p
    ptrs = [p(t.data_ptr()) for t in (
        feat0, feat1, m0, m1, row_pa, row_pb, col_pa, col_pb, rmax, rsum,
        cmax, csum, best_val, best_j, colconf)]
    err = lib.loftr_dual_softmax(*ptrs, B, L, S, C, ct,
                                 1.0 / (C * float(temperature)), code,
                                 p(_build.stream_ptr(feat0)))
    _build.check(err, "loftr_dual_softmax")
    fused_dual_softmax_match.launches += 1
    return best_val, best_j, colconf


fused_dual_softmax_match.launches = 0
