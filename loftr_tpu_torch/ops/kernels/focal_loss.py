"""Kernel D: the fused dense focal coarse loss, forward and backward.

Replaces ``loftr_tpu/ops/pallas/focal_loss.py::fused_focal_sums`` (forward
``_stats_kernel`` + ``_loss_kernel``; backward ``_srow_scol_kernel`` +
``_grad_kernel``).  CUDA source: ``csrc/focal_loss.cu``; the row/column
softmax statistics come from kernel B's first pass (``csrc/dual_softmax.cu``).

It computes, per image pair, the positive and the negative sum of the dense
focal terms over ``conf = softmax_rows(sim) * softmax_cols(sim)`` and their
gradients with respect to both feature maps, in O(L + S) memory: every pass
recomputes the sim tiles it needs, and the [L, S] matrix (92 MB in float32
for a 640x480 pair, kept several times over by autograd on the plain path)
never reaches device memory.

Rounding.  The JAX kernel scales the features by ``s = 1/sqrt(C*T)`` before
its passes; for bfloat16 features JAX rounds ``s`` and each scaled feature
to bfloat16, and every sim, statistic, confidence and gradient is built on
those copies (the gradient then takes the float ``s``).  Here bfloat16
features go through the same copies ``bf16(f * bf16(s))`` (a prescale
kernel; :func:`prescale_plain` on the CPU) with slope ``s``; float32
features keep the raw dot scaled by ``1/(C*T)``, as JAX rounds there only at
float32.

What bounds it on the H100: operations.  Forward: two sim products of
2*L*S*C flop (statistics, loss); backward: two gradient grids, each a sim
product and a gradient product of 2*L*S*C, all on the bf16 tensor cores.

Design, bfloat16 at C = 256 (``csrc/focal_loss.cu``, namespace ``bf``):
kernel B's bf16 pass 1 gives the statistics; the loss pass (kernel B's 128
x 128 tile, chunks from :func:`loss_plan`) forms the sums and, when the
features need a gradient, the class-split row and column sums of
``a = focal'(conf) w conf`` that make the JAX backward's first pass
unnecessary; two gradient grids (one a side, :func:`grad_plan`) each form
sim, ``dsim`` and ``dsim @ f`` on ``mma.sync``, ``dsim`` split into bf16
hi and lo halves.  Other widths and float32: the 64x64 tile kernels (float
gradient products on the CUDA cores), bfloat16 still on the prescaled
copies.

``fused_focal_sums`` launches the kernels for CUDA tensors and runs
:func:`focal_sums_plain` (which materialises sim and conf and lets autograd
differentiate) for CPU tensors only.  ``fused_focal_sums.launches`` counts
forward wrapper calls, ``fused_focal_sums.backward_launches`` backward
ones.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from loftr_tpu_torch.ops.kernels import _build
from loftr_tpu_torch.ops.kernels.dual_softmax import (BF16_C, NEG, TILE,
                                                      _chunk_tiles,
                                                      _mask_vectors,
                                                      _sm_count, bf16_plan)

EPS = 1e-6       # conf clamp of the reference loss
MAX_C = 256      # the gradient kernel keeps a [64, 256] float tile per block
# bf16 path (C = 256): the gradient grids' tile -- 128 resident rows of one
# side (8 warps x 16 rows), GRAD_COLS streamed rows of the other a tile,
# all 256 output columns a block (fixed in csrc/focal_loss.cu's C entry) --
# and a block's set-up (the
# resident rows, the ring fill, its partial-gradient writes) in streamed
# tiles, for grad_plan; and the loss pass's set-up in its 128-row tiles
# (kernel B's tile), for loss_plan.  tools/focal_plan_sweep.py measured
# them: with these costs both plans pick the fastest chunk count it found
# at [1,4800,256] and [2,4800,256].  64-row tiles with all 256 output
# columns spill; 32-row ones do not.
GRAD_ROWS, GRAD_COLS = 128, 32
GRAD_BLOCK_COST = 4.0
LOSS_BLOCK_COST = 0.25


def feature_scale(C: int, temperature: float) -> Tuple[float, float]:
    """(s, bf16(s)) with s = 1/sqrt(C*T): the JAX kernel's feature scale,
    as a float and rounded to bfloat16 (as JAX's weak typing rounds it)."""
    s = (1.0 / C ** 0.5) / (float(temperature) ** 0.5)
    return s, float(torch.tensor(s, dtype=torch.bfloat16))


def prescale_plain(f: torch.Tensor, temperature: float) -> torch.Tensor:
    """Float32 copy of bfloat16 features with the value bf16(f * bf16(s))
    (JAX's rounded copy) and the slope s (straight through the rounding)."""
    s, sb = feature_scale(f.shape[-1], temperature)
    x = f.float() * s
    r = (f.float() * sb).to(torch.bfloat16).float()
    return x + (r - x).detach()


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
    m0, m1 = _mask_vectors(B, L, S, mask0, mask1, feat0.device)
    w = m0[:, :, None] * m1[:, None, :]
    if feat0.dtype == torch.bfloat16:
        sim = torch.matmul(prescale_plain(feat0, temperature),
                           prescale_plain(feat1, temperature).transpose(1, 2))
    else:
        sim = torch.matmul(feat0.float(), feat1.float().transpose(1, 2)) * (
            1.0 / (C * float(temperature)))
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


def loss_plan(B: int, L: int, S: int, sms: int = 132
              ) -> Tuple[int, int, int]:
    """(chunk_tiles, nrt, nch) of the loss pass: kernel B's 128 x 128 tile,
    :func:`bf16_plan` with the loss pass's set-up cost."""
    _, _, ct, nrt, nch = bf16_plan(B, L, S, sms, block_cost=LOSS_BLOCK_COST)
    return ct, nrt, nch


def grad_plan(B: int, La: int, Lb: int, sms: int = 132
              ) -> Tuple[int, int, int]:
    """(chunk_tiles, nrt, nch) of the gradient grid that owns side a (La
    rows) and streams side b (Lb rows): :func:`bf16_plan` over its B x nrt
    x nch blocks of GRAD_ROWS rows and GRAD_COLS-row tiles."""
    _, _, ct, nrt, nch = bf16_plan(B, La, Lb, sms, GRAD_ROWS, GRAD_COLS,
                                   GRAD_BLOCK_COST)
    return ct, nrt, nch


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


def _ptrs(*tensors):
    return [ctypes.c_void_p(None if t is None else t.data_ptr())
            for t in tensors]


def _f32(dev, *sizes):
    """One float32 allocation split into tensors of the given sizes."""
    return torch.empty(sum(sizes), dtype=torch.float32,
                       device=dev).split(list(sizes))


class _FocalSums(torch.autograd.Function):
    """CUDA forward and backward of the focal sums."""

    @staticmethod
    def forward(ctx, feat0, feat1, gt_j, gt_valid, mask0, mask1, temperature,
                alpha, gamma, grad):
        _check(feat0, feat1, gt_j, gt_valid)
        B, L, C = feat0.shape
        S = feat1.shape[1]
        code = _build.dtype_code(feat0)
        lib = _build.library()
        dev = feat0.device
        st = ctypes.c_void_p(_build.stream_ptr(feat0))
        gtj = gt_j.to(torch.int32).contiguous()
        gtv = gt_valid.to(torch.float32).contiguous()
        alpha, gamma = float(alpha), float(gamma)
        pos = torch.empty((B,), dtype=torch.float32, device=dev)
        neg = torch.empty((B,), dtype=torch.float32, device=dev)
        if code == 1:
            s, sb = feature_scale(C, temperature)
            x0, x1 = torch.empty_like(feat0), torch.empty_like(feat1)
            err = lib.loftr_focal_prescale(
                *_ptrs(feat0, feat1, x0, x1), feat0.numel(), feat1.numel(),
                sb, st)
            _build.check(err, "loftr_focal_prescale")
            sim_scale, grad_scale = 1.0, s
        else:
            x0, x1 = feat0, feat1
            sim_scale = grad_scale = 1.0 / (C * float(temperature))
        fast = code == 1 and C == BF16_C
        if fast:
            # kernel B's pass 1 (statistics), then the loss pass
            m0 = m1 = None
            if mask0 is not None or mask1 is not None:
                m0, m1 = _mask_vectors(B, L, S, mask0, mask1, dev)
            sms = _sm_count(dev.index)
            rows, cols, ct, nrt, nch = bf16_plan(B, L, S, sms)
            (ra, rb, ca, cb, rstat, cstat) = _f32(
                dev, B * nch * L, B * nch * L, B * nrt * S, B * nrt * S,
                2 * B * L, 2 * B * S)
            err = lib.loftr_dual_softmax_bf16_stats(
                *_ptrs(x0, x1, m0, m1, ra, rb, ca, cb, rstat, cstat),
                B, L, S, C, rows, cols, ct, 1.0, st)
            _build.check(err, "loftr_dual_softmax_bf16_stats")
            ct, nrt, nch = loss_plan(B, L, S, sms)
            n_grad = (2 * B * nch * L, 2 * B * nrt * S, 2 * B * L,
                      2 * B * S) if grad else (0, 0, 0, 0)
            part, row_p, col_p, srow2, scol2 = _f32(
                dev, B * nrt * nch * 2, *n_grad)
            err = lib.loftr_focal_bf16_fwd(
                *_ptrs(x0, x1, m0, m1, rstat, cstat, gtj, gtv, part,
                       row_p if grad else None, col_p if grad else None, pos,
                       neg, srow2 if grad else None,
                       scol2 if grad else None),
                B, L, S, ct, alpha, gamma, int(grad), st)
            _build.check(err, "loftr_focal_bf16_fwd")
            saved = (x0, x1, m0, m1, rstat, cstat, srow2, scol2, gtj, gtv)
        else:
            m0, m1 = _mask_vectors(B, L, S, mask0, mask1, dev)
            ct = _chunk_tiles(B, L, S)
            nrt = math.ceil(L / TILE)
            nch = math.ceil(math.ceil(S / TILE) / ct)
            ra, rb, ca, cb, rmax, rsum, cmax, csum, part = _f32(
                dev, B * nch * L, B * nch * L, B * nrt * S, B * nrt * S,
                B * L, B * L, B * S, B * S, B * nrt * nch * 2)
            # pass 1: kernel B's statistics pass
            err = lib.loftr_dual_softmax_stats(
                *_ptrs(x0, x1, m0, m1, ra, rb, ca, cb, rmax, rsum, cmax,
                       csum), B, L, S, C, ct, sim_scale, code, st)
            _build.check(err, "loftr_dual_softmax_stats")
            # pass 2: focal sums
            err = lib.loftr_focal_fwd(
                *_ptrs(x0, x1, m0, m1, rmax, rsum, cmax, csum, gtj, gtv,
                       part, pos, neg),
                B, L, S, C, ct, sim_scale, alpha, gamma, code, st)
            _build.check(err, "loftr_focal_fwd")
            saved = (x0, x1, m0, m1, rmax, rsum, cmax, csum, gtj, gtv)
        fused_focal_sums.launches += 1
        if grad:
            ctx.save_for_backward(*saved)
        ctx.consts = (fast, ct, sim_scale, grad_scale, alpha, gamma, code)
        return pos, neg

    @staticmethod
    def backward(ctx, gpos, gneg):
        fast, ct, sim_scale, grad_scale, alpha, gamma, code = ctx.consts
        saved = ctx.saved_tensors
        x0, x1 = saved[:2]
        B, L, C = x0.shape
        S = x1.shape[1]
        dev = x0.device
        lib = _build.library()
        st = ctypes.c_void_p(_build.stream_ptr(x0))
        gpos = gpos.to(torch.float32).contiguous()
        gneg = gneg.to(torch.float32).contiguous()
        df0 = torch.empty_like(x0)
        df1 = torch.empty_like(x1)
        if fast:
            (_, _, m0, m1, rstat, cstat, srow2, scol2, gtj, gtv) = saved
            sms = _sm_count(dev.index)
            ct0, _, nch0 = grad_plan(B, L, S, sms)
            ct1, _, nch1 = grad_plan(B, S, L, sms)
            part0, part1 = _f32(dev, B * nch0 * L * C if nch0 > 1 else 0,
                                B * nch1 * S * C if nch1 > 1 else 0)
            err = lib.loftr_focal_bf16_bwd(
                *_ptrs(x0, x1, m0, m1, rstat, cstat, srow2, scol2, gtj, gtv,
                       gpos, gneg, part0 if nch0 > 1 else None,
                       part1 if nch1 > 1 else None, df0, df1),
                B, L, S, ct0, ct1, grad_scale, alpha, gamma, st)
            _build.check(err, "loftr_focal_bf16_bwd")
        else:
            (_, _, m0, m1, rmax, rsum, cmax, csum, gtj, gtv) = saved
            nrt = math.ceil(L / TILE)
            nch = math.ceil(math.ceil(S / TILE) / ct)
            row_p, col_p, srow, scol = _f32(dev, B * nch * L, B * nrt * S,
                                            B * L, B * S)
            err = lib.loftr_focal_bwd(
                *_ptrs(x0, x1, m0, m1, rmax, rsum, cmax, csum, gtj, gtv,
                       gpos, gneg, row_p, col_p, srow, scol, df0, df1),
                B, L, S, C, ct, sim_scale, grad_scale, alpha, gamma, code, st)
            _build.check(err, "loftr_focal_bwd")
        fused_focal_sums.backward_launches += 1
        return df0, df1, None, None, None, None, None, None, None, None


def fused_focal_sums(feat0: torch.Tensor, feat1: torch.Tensor,
                     gt_j: torch.Tensor, gt_valid: torch.Tensor,
                     mask0: Optional[torch.Tensor] = None,
                     mask1: Optional[torch.Tensor] = None,
                     temperature: float = 0.1, alpha: float = 0.25,
                     gamma: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_sum [B], neg_sum [B]) of the dense focal terms over the
    dual-softmax confidences, differentiable with respect to the features.

    feat0 [B, L, C], feat1 [B, S, C]: raw coarse features, float32 or
    bfloat16 (bfloat16 is rounded as the JAX kernel rounds it: see the
    module docstring).  gt_j [B, L] integer and gt_valid [B, L]: the per-row
    ground truth.  mask0 [B, L] / mask1 [B, S] optional, 0/1; the cell
    weight is mask0 * mask1.  The caller divides by its own (batch-global)
    counts."""
    if _build.runs_plain("focal-loss kernel", feat0, feat1, gt_j,
                          gt_valid, mask0, mask1):
        return focal_sums_plain(feat0, feat1, gt_j, gt_valid, mask0, mask1,
                                temperature, alpha, gamma)
    grad = torch.is_grad_enabled() and (feat0.requires_grad
                                        or feat1.requires_grad)
    return _FocalSums.apply(feat0, feat1, gt_j, gt_valid, mask0, mask1,
                            temperature, alpha, gamma, grad)


fused_focal_sums.launches = 0
fused_focal_sums.backward_launches = 0
