"""Kernel B: dual-softmax + mutual-nearest statistics, no [L, S] matrix.

Replaces ``loftr_tpu/ops/pallas/dual_softmax.py::_fused_dual_softmax_core``
(``_stats_kernel`` and ``_best_kernel``).  CUDA source:
``csrc/dual_softmax.cu``.

What bounds it on the H100: operations, 2 x 2*L*S*C flop (the sim tiles
are computed twice) plus 4*L*S exponentials, against (L+S)*C input values.
The kernel recomputes sim tiles in each pass instead of storing the 92 MB
[L, S] matrix of a 640x480 pair.  Blocks own a row tile and a chunk of
columns, so row and column statistics come out as partials that small
kernels combine in a fixed order (log-sum-exp for the softmax statistics,
max with the lowest index on ties for the row best).

bfloat16 features (C = 256) go to the ``mma.sync`` path: R = 128 rows of
f0 resident in shared memory, N = 128 f1 rows a tile through a ``cp.async``
ring, epilogues on the accumulators; :func:`bf16_plan` picks the column
chunk a block so the grid fills whole waves of the card's SMs.  float32
features go to the 64x64 tile kernel (the exactness check).

``fused_dual_softmax_match`` launches a kernel for CUDA tensors and runs
:func:`dual_softmax_plain` (which materialises sim and conf) for CPU tensors
only.  ``fused_dual_softmax_match.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from loftr_tpu_torch.ops.kernels import _build

NEG = -1e9
TILE = 64          # row and column tile of the float (and stats) kernels
TARGET_BLOCKS = 4 * 132  # enough blocks to fill an H100's 132 SMs
# bfloat16 path (csrc/dual_softmax.cu, namespace bf): the feature width it
# takes, its row x column tile, and the cost of a block's set-up (staging
# the row tile, filling the ring, the row epilogue) in column tiles
BF16_C = 256
BF16_ROWS, BF16_COLS = 128, 128
BF16_BLOCK_COST = 0.5


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


def bf16_plan(B: int, L: int, S: int, sms: int = 132,
              rows: int = BF16_ROWS, cols: int = BF16_COLS,
              block_cost: float = BF16_BLOCK_COST
              ) -> Tuple[int, int, int, int, int]:
    """Launch plan of the bfloat16 path: (rows, cols, chunk_tiles, nrt,
    nch).  Block (row tile, chunk) covers column tiles [chunk *
    chunk_tiles, min(nct, (chunk + 1) * chunk_tiles)).  One block runs on
    an SM at a time, so the grid's time is its waves times a block's column
    tiles plus its set-up (``block_cost`` column tiles); the chunk count
    minimises that (fewest blocks on ties)."""
    nrt, nct = math.ceil(L / rows), math.ceil(S / cols)
    best = None
    for n in range(1, nct + 1):
        ct = math.ceil(nct / n)
        nch = math.ceil(nct / ct)
        cost = math.ceil(B * nrt * nch / sms) * (ct + block_cost)
        if best is None or (cost, nch) < best[:2]:
            best = (cost, nch, ct)
    _, nch, ct = best
    return rows, cols, ct, nrt, nch


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_bf16(feat0, feat1, scale, mask0, mask1):
    B, L, C = feat0.shape
    S = feat1.shape[1]
    if C != BF16_C:
        raise ValueError(f"dual-softmax kernel: bfloat16 takes C={BF16_C}, "
                         f"got C={C}")
    if feat0.data_ptr() % 16 or feat1.data_ptr() % 16:
        raise ValueError("dual-softmax kernel: bfloat16 features must be "
                         "16-byte aligned")
    dev = feat0.device
    rows, cols, ct, nrt, nch = bf16_plan(B, L, S, _sm_count(dev.index))
    m0 = m1 = None
    if mask0 is not None or mask1 is not None:
        m0, m1 = _mask_vectors(B, L, S, mask0, mask1, dev)
    # row_pa, row_pb [B, nch, L], col_pa, col_pb [B, nrt, S], rstat
    # [2, B, L], cstat [2, B, S]
    sizes = (B * nch * L, B * nch * L, B * nrt * S, B * nrt * S, 2 * B * L,
             2 * B * S)
    scratch = torch.empty(sum(sizes), dtype=torch.float32,
                          device=dev).split(sizes)
    best_val = torch.empty((B, L), dtype=torch.float32, device=dev)
    best_j = torch.empty((B, L), dtype=torch.int32, device=dev)
    colconf = torch.empty((B, S), dtype=torch.float32, device=dev)
    p = ctypes.c_void_p
    ptrs = [p(None if t is None else t.data_ptr()) for t in (
        feat0, feat1, m0, m1, *scratch, best_val, best_j, colconf)]
    err = _build.library().loftr_dual_softmax_bf16(
        *ptrs, B, L, S, C, rows, cols, ct, scale, p(_build.stream_ptr(feat0)))
    _build.check(err, "loftr_dual_softmax_bf16")
    return best_val, best_j, colconf


def fused_dual_softmax_match(feat0: torch.Tensor, feat1: torch.Tensor,
                             temperature: float = 0.1,
                             mask0: Optional[torch.Tensor] = None,
                             mask1: Optional[torch.Tensor] = None):
    """feat0: [B, L, C], feat1: [B, S, C] (raw transformer outputs; the
    1/(C*T) scaling is applied to the float dot here).  mask0 [B, L] /
    mask1 [B, S] optional.  Returns (best_val [B, L] float32, best_j [B, L]
    int32, colconf [B, S] float32)."""
    if _build.runs_plain("dual-softmax kernel", feat0, feat1, mask0,
                          mask1):
        return dual_softmax_plain(feat0, feat1, temperature, mask0, mask1)
    B, L, C = feat0.shape
    S = feat1.shape[1]
    if feat1.shape[0] != B or feat1.shape[2] != C or feat1.dtype != feat0.dtype:
        raise ValueError("feat0 and feat1 must share batch, width and dtype")
    if not (feat0.is_contiguous() and feat1.is_contiguous()):
        raise ValueError("dual-softmax kernel takes contiguous features")
    code = _build.dtype_code(feat0)
    scale = 1.0 / (C * float(temperature))
    if code == 1:
        out = _launch_bf16(feat0, feat1, scale, mask0, mask1)
        fused_dual_softmax_match.launches += 1
        return out
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
    err = lib.loftr_dual_softmax(*ptrs, B, L, S, C, ct, scale, code,
                                 p(_build.stream_ptr(feat0)))
    _build.check(err, "loftr_dual_softmax")
    fused_dual_softmax_match.launches += 1
    return best_val, best_j, colconf


fused_dual_softmax_match.launches = 0
