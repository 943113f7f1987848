"""Kernel D: the fused dense focal coarse loss, forward and backward.

Replaces ``loftr_tpu/ops/pallas/focal_loss.py::fused_focal_sums`` (forward
``_stats_kernel`` + ``_loss_kernel``; backward ``_srow_scol_kernel`` +
``_grad_kernel``).  CUDA source: ``csrc/focal_loss.cu``; the row/column
softmax statistics come from kernel B's first pass
(``csrc/dual_softmax.cu``, entry ``loftr_dual_softmax_stats``).

It computes, per image pair, the positive and the negative sum of the dense
focal terms over ``conf = softmax_rows(sim) * softmax_cols(sim)`` and their
gradients with respect to both feature maps, in O(L + S) memory: every pass
recomputes the 64x64 sim tiles it needs, and the [L, S] matrix (92 MB in
float32 for a 640x480 pair, kept several times over by autograd on the plain
path) never reaches device memory.

What bounds it on the H100: operations.  Forward 2 x 2*L*S*C flop, backward
2*L*S*C (pass B1) + 2 x 4*L*S*C (the two B2 grids each recompute sim and
form one gradient product), against (L+S)*C values in and out.

Design.  The TPU kernels carry the scalar sums, ``Scol`` and ``dfeat1``
across a sequential grid.  Here the scalar sums and ``Srow``/``Scol`` come
out as per-block partials that small kernels add in a fixed order, and the
two gradients come from two grids of the same kernel: one owns 64-row tiles
of image 0 and loops over the columns (``dfeat0``), the other owns 64-row
tiles of image 1 and loops over image 0 (``dfeat1``), so nothing is summed
across blocks and no float atomics are used: a step is reproducible.  The
sim tiles of bfloat16 features run on the tensor cores (exact products,
float accumulation); ``dsim`` is float32, so the two gradient products run
in float32 on the CUDA cores.  The upstream cotangents reach the kernels as
device pointers (no host synchronisation in a step).

``fused_focal_sums`` launches the kernels for CUDA tensors and runs
:func:`focal_sums_plain` (which materialises sim and conf and lets autograd
differentiate) for CPU tensors only.  ``fused_focal_sums.launches`` counts
forward launches, ``fused_focal_sums.backward_launches`` backward ones.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from loftr_tpu_torch.ops.kernels import _build
from loftr_tpu_torch.ops.kernels.dual_softmax import (NEG, TILE, _chunk_tiles,
                                                      _mask_vectors)

EPS = 1e-6       # conf clamp of the reference loss
MAX_C = 256      # the gradient kernel keeps a [64, 256] float tile per block


def focal_sums_plain(feat0: torch.Tensor, feat1: torch.Tensor,
                     gt_j: torch.Tensor, gt_valid: torch.Tensor,
                     mask0: Optional[torch.Tensor] = None,
                     mask1: Optional[torch.Tensor] = None,
                     temperature: float = 0.1, alpha: float = 0.25,
                     gamma: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version (materialises [B, L, S]; autograd gives the
    gradients).  Returns (pos_sum [B], neg_sum [B]) float32."""
    B, L, C = feat0.shape
    S = feat1.shape[1]
    scale = 1.0 / (C * float(temperature))
    m0, m1 = _mask_vectors(B, L, S, mask0, mask1, feat0.device)
    w = m0[:, :, None] * m1[:, None, :]
    sim = torch.matmul(feat0.float(), feat1.float().transpose(1, 2)) * scale
    sim = sim + (w - 1.0) * (-NEG)
    conf = torch.softmax(sim, dim=2) * torch.softmax(sim, dim=1)
    c = conf.clamp(EPS, 1.0 - EPS)
    cols = torch.arange(S, device=feat0.device)
    is_pos = (gt_j.long()[:, :, None] == cols) & gt_valid.bool()[:, :, None]
    loss_pos = -alpha * (1.0 - c) ** gamma * torch.log(c)
    loss_neg = -alpha * c ** gamma * torch.log1p(-c)
    zero = torch.zeros((), dtype=torch.float32, device=feat0.device)
    pos = torch.where(is_pos, loss_pos * w, zero).sum(dim=(1, 2))
    neg = torch.where(is_pos, zero, loss_neg * w).sum(dim=(1, 2))
    return pos, neg


def _check(feat0, feat1, gt_j, gt_valid):
    B, L, C = feat0.shape
    if feat1.shape[0] != B or feat1.shape[2] != C or feat1.dtype != feat0.dtype:
        raise ValueError("feat0 and feat1 must share batch, width and dtype")
    if C > MAX_C:
        raise ValueError(f"focal-loss kernel takes C <= {MAX_C}, got {C}")
    if gt_j.shape != (B, L) or gt_valid.shape != (B, L):
        raise ValueError("gt_j and gt_valid must be [B, L]")
    if not (feat0.is_contiguous() and feat1.is_contiguous()):
        raise ValueError("focal-loss kernel takes contiguous features")


class _FocalSums(torch.autograd.Function):
    """CUDA forward and backward of the focal sums."""

    @staticmethod
    def forward(ctx, feat0, feat1, gt_j, gt_valid, mask0, mask1, temperature,
                alpha, gamma):
        _check(feat0, feat1, gt_j, gt_valid)
        B, L, C = feat0.shape
        S = feat1.shape[1]
        code = _build.dtype_code(feat0)
        lib = _build.library()
        dev = feat0.device
        f32 = dict(dtype=torch.float32, device=dev)
        m0, m1 = _mask_vectors(B, L, S, mask0, mask1, dev)
        gtj = gt_j.to(torch.int32).contiguous()
        gtv = gt_valid.to(torch.float32).contiguous()
        ct = _chunk_tiles(B, L, S)
        nrt = math.ceil(L / TILE)
        nch = math.ceil(math.ceil(S / TILE) / ct)
        scale = 1.0 / (C * float(temperature))
        row_pa = torch.empty((B, nch, L), **f32)
        row_pb = torch.empty((B, nch, L), **f32)
        col_pa = torch.empty((B, nrt, S), **f32)
        col_pb = torch.empty((B, nrt, S), **f32)
        rmax = torch.empty((B, L), **f32)
        rsum = torch.empty((B, L), **f32)
        cmax = torch.empty((B, S), **f32)
        csum = torch.empty((B, S), **f32)
        p = ctypes.c_void_p
        st = p(_build.stream_ptr(feat0))
        # pass 1: kernel B's statistics pass
        err = lib.loftr_dual_softmax_stats(
            *[p(t.data_ptr()) for t in (feat0, feat1, m0, m1, row_pa, row_pb,
                                        col_pa, col_pb, rmax, rsum, cmax,
                                        csum)],
            B, L, S, C, ct, scale, code, st)
        _build.check(err, "loftr_dual_softmax_stats")
        # pass 2: focal sums
        part = torch.empty((B, nrt * nch, 2), **f32)
        pos = torch.empty((B,), **f32)
        neg = torch.empty((B,), **f32)
        err = lib.loftr_focal_fwd(
            *[p(t.data_ptr()) for t in (feat0, feat1, m0, m1, rmax, rsum, cmax,
                                        csum, gtj, gtv, part, pos, neg)],
            B, L, S, C, ct, scale, float(alpha), float(gamma), code, st)
        _build.check(err, "loftr_focal_fwd")
        fused_focal_sums.launches += 1
        ctx.save_for_backward(feat0, feat1, m0, m1, rmax, rsum, cmax, csum,
                              gtj, gtv)
        ctx.consts = (ct, scale, float(alpha), float(gamma), code)
        return pos, neg

    @staticmethod
    def backward(ctx, gpos, gneg):
        (feat0, feat1, m0, m1, rmax, rsum, cmax, csum, gtj,
         gtv) = ctx.saved_tensors
        ct, scale, alpha, gamma, code = ctx.consts
        B, L, C = feat0.shape
        S = feat1.shape[1]
        lib = _build.library()
        f32 = dict(dtype=torch.float32, device=feat0.device)
        nrt = math.ceil(L / TILE)
        nch = math.ceil(math.ceil(S / TILE) / ct)
        row_p = torch.empty((B, nch, L), **f32)
        col_p = torch.empty((B, nrt, S), **f32)
        gpos = gpos.to(torch.float32).contiguous()
        gneg = gneg.to(torch.float32).contiguous()
        srow = torch.empty((B, L), **f32)
        scol = torch.empty((B, S), **f32)
        df0 = torch.empty_like(feat0)
        df1 = torch.empty_like(feat1)
        p = ctypes.c_void_p
        err = lib.loftr_focal_bwd(
            *[p(t.data_ptr()) for t in (feat0, feat1, m0, m1, rmax, rsum, cmax,
                                        csum, gtj, gtv, gpos, gneg, row_p,
                                        col_p, srow, scol, df0, df1)],
            B, L, S, C, ct, scale, alpha, gamma, code,
            p(_build.stream_ptr(feat0)))
        _build.check(err, "loftr_focal_bwd")
        fused_focal_sums.backward_launches += 1
        return df0, df1, None, None, None, None, None, None, None


def fused_focal_sums(feat0: torch.Tensor, feat1: torch.Tensor,
                     gt_j: torch.Tensor, gt_valid: torch.Tensor,
                     mask0: Optional[torch.Tensor] = None,
                     mask1: Optional[torch.Tensor] = None,
                     temperature: float = 0.1, alpha: float = 0.25,
                     gamma: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_sum [B], neg_sum [B]) of the dense focal terms over the
    dual-softmax confidences, differentiable with respect to the features.

    feat0 [B, L, C], feat1 [B, S, C]: raw coarse features, float32 or
    bfloat16 (the 1/(C*T) scaling is applied to the float dot).  gt_j [B, L]
    integer and gt_valid [B, L]: the per-row ground truth.  mask0 [B, L] /
    mask1 [B, S] optional; the cell weight is mask0 * mask1.  The caller
    divides by its own (batch-global) counts."""
    if _build.runs_plain("focal-loss kernel", feat0, feat1, gt_j,
                          gt_valid, mask0, mask1):
        return focal_sums_plain(feat0, feat1, gt_j, gt_valid, mask0, mask1,
                                temperature, alpha, gamma)
    return _FocalSums.apply(feat0, feat1, gt_j, gt_valid, mask0, mask1,
                            temperature, alpha, gamma)


fused_focal_sums.launches = 0
fused_focal_sums.backward_launches = 0
