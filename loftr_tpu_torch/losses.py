"""LoFTR loss: coarse focal / cross-entropy + fine L2 (with std), in static
shapes (``loftr_tpu.losses``; the reference's loftr_loss.py).

Each term is a mean over its mask's cell count, with optional per-cell
padding weights multiplied into the numerator, and contributes 0 when its
mask is empty.  The dense focal loss of the dual-softmax matcher has a
second route, :func:`_fused_coarse_loss`, through the focal-loss kernel
module: it takes the coarse features instead of the [B, L, S] confidence
matrix.

Inside ``parallel.comm.data_parallel`` every denominator is the global
batch's (``comm.batch_total``), as under JAX's data-sharded mesh, while the
numerators stay this rank's: the loss a rank returns is its part of the
global loss, the parts sum to it, and the sum of the ranks' gradients is
its gradient (``train/trainer.py``).  Outside it the terms are the plain
means, bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from loftr_tpu_torch.config import LossConfig, MatchCoarseConfig
from loftr_tpu_torch.ops.kernels.focal_loss import fused_focal_sums
from loftr_tpu_torch.parallel.comm import batch_total, data_group
from loftr_tpu_torch.structs import MatchInput, MatchResult, Supervision


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(values * mask) / count(mask), 0 if the mask is empty; the count
    is the global batch's under data parallelism."""
    mask = mask.to(values.dtype)
    count = batch_total(mask.sum())
    total = (values * mask).sum()
    return torch.where(count > 0, total / count.clamp_min(1),
                       torch.zeros_like(total))


def compute_c_weight(inp: MatchInput) -> Optional[torch.Tensor]:
    """Padding-mask outer product weight [B, L, S], or None without masks."""
    if inp.mask0 is None:
        return None
    b = inp.mask0.shape[0]
    m0 = inp.mask0.reshape(b, -1).float()
    m1 = inp.mask1.reshape(b, -1).float()
    return m0[:, :, None] * m1[:, None, :]


def coarse_loss(conf: torch.Tensor, conf_gt: torch.Tensor, cfg: LossConfig,
                mc: MatchCoarseConfig,
                weight: Optional[torch.Tensor] = None,
                conf_with_bin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coarse-level loss.  conf: [B, L, S] confidence; conf_gt: [B, L, S]
    bool; conf_with_bin: [B, L+1, S+1] (sparse Sinkhorn supervision only)."""
    pos = conf_gt.float()
    neg = 1.0 - pos
    w = weight if weight is not None else 1.0

    if cfg.coarse_type == "cross_entropy":
        if mc.sparse_spvs:
            raise NotImplementedError(
                "sparse supervision for cross-entropy (as the reference)")
        c = conf.clamp(1e-6, 1 - 1e-6)
        loss_pos = _masked_mean(-torch.log(c) * w, pos)
        loss_neg = _masked_mean(-torch.log1p(-c) * w, neg)
        return cfg.pos_weight * loss_pos + cfg.neg_weight * loss_neg

    if cfg.coarse_type != "focal":
        raise ValueError(cfg.coarse_type)
    alpha, gamma = cfg.focal_alpha, cfg.focal_gamma

    if mc.sparse_spvs:
        if mc.match_type == "sinkhorn":
            if conf_with_bin is None:
                raise ValueError("sparse Sinkhorn supervision needs "
                                 "conf_with_bin")
            cb = conf_with_bin.clamp(1e-6, 1 - 1e-6)
            inner = cb[:, :-1, :-1]
            loss_pos = _masked_mean(
                -alpha * (1 - inner) ** gamma * torch.log(inner) * w, pos)
            # dustbin negatives: rows and columns with no GT
            neg0 = ~conf_gt.any(dim=2)                     # [B, L]
            neg1 = ~conf_gt.any(dim=1)                     # [B, S]
            bin_col = cb[:, :-1, -1]
            bin_row = cb[:, -1, :-1]
            if weight is not None:
                neg0 = neg0 & (weight.sum(dim=2) != 0)
                neg1 = neg1 & (weight.sum(dim=1) != 0)
            l0 = -alpha * (1 - bin_col) ** gamma * torch.log(bin_col)
            l1 = -alpha * (1 - bin_row) ** gamma * torch.log(bin_row)
            n_neg = batch_total(neg0.sum() + neg1.sum())
            total = (l0 * neg0).sum() + (l1 * neg1).sum()
            loss_neg = torch.where(n_neg > 0, total / n_neg.clamp_min(1),
                                   torch.zeros_like(total))
            return cfg.pos_weight * loss_pos + cfg.neg_weight * loss_neg
        # dual-softmax sparse: positives only
        c = conf.clamp(1e-6, 1 - 1e-6)
        loss_pos = _masked_mean(
            -alpha * (1 - c) ** gamma * torch.log(c) * w, pos)
        return cfg.pos_weight * loss_pos
    # dense supervision
    c = conf.clamp(1e-6, 1 - 1e-6)
    loss_pos = _masked_mean(-alpha * (1 - c) ** gamma * torch.log(c) * w, pos)
    loss_neg = _masked_mean(-alpha * c ** gamma * torch.log1p(-c) * w, neg)
    return cfg.pos_weight * loss_pos + cfg.neg_weight * loss_neg


def fine_loss(expec_f: torch.Tensor, expec_f_gt: torch.Tensor,
              cfg: LossConfig,
              slot_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fine-level loss.  expec_f: [B, K, 3] (x, y, std); expec_f_gt:
    [B, K, 2]; slot_mask: [B, K] valid slots.  0 when no slot is correct."""
    if slot_mask is None:
        slot_mask = torch.ones(expec_f.shape[:2], dtype=torch.bool,
                               device=expec_f.device)
    correct = (expec_f_gt.abs().amax(dim=-1) < cfg.fine_correct_thr) \
        & slot_mask

    offset_l2 = ((expec_f_gt - expec_f[..., :2]) ** 2).sum(dim=-1)
    if cfg.fine_type == "l2":
        return _masked_mean(offset_l2, correct)
    if cfg.fine_type != "l2_with_std":
        raise NotImplementedError(cfg.fine_type)

    inverse_std = 1.0 / expec_f[..., 2].clamp_min(1e-10)
    # normalised by the mean inverse std over the valid slots (of the
    # global batch); detached, so the loss cannot be lowered by inflating std
    mean_inv = batch_total(_masked_mean(inverse_std.detach(), slot_mask))
    weight = (inverse_std / mean_inv.clamp_min(1e-10)).detach()
    return _masked_mean(offset_l2 * weight, correct)


def _fused_coarse_loss(result: MatchResult, spv: Supervision,
                       inp: MatchInput, cfg: LossConfig,
                       mc: MatchCoarseConfig) -> torch.Tensor:
    """Dense focal loss of a batch through the focal-loss kernel module: no
    [B, L, S] matrix; the mean denominators are batch-global, as in
    :func:`coarse_loss`."""
    f0, f1 = result.feat_c0, result.feat_c1
    B, L, _ = f0.shape
    S = f1.shape[1]
    m0 = None if inp.mask0 is None else inp.mask0.reshape(B, L)
    m1 = None if inp.mask1 is None else inp.mask1.reshape(B, S)
    p, n = fused_focal_sums(f0.contiguous(), f1.contiguous(), spv.gt_j,
                            spv.gt_valid, m0, m1, mc.dsmax_temperature,
                            cfg.focal_alpha, cfg.focal_gamma)
    n_pos = batch_total(spv.gt_valid.sum().float())
    n_cells = float(B * L * S)
    if data_group() is not None:       # the global batch's cells
        n_cells = batch_total(torch.tensor(n_cells, device=f0.device))
    n_neg = n_cells - n_pos
    zero = torch.zeros_like(n_pos)
    mean_pos = torch.where(n_pos > 0, p.sum() / n_pos.clamp_min(1), zero)
    mean_neg = torch.where(n_neg > 0, n.sum() / n_neg.clamp_min(1), zero)
    return cfg.pos_weight * mean_pos + cfg.neg_weight * mean_neg


def loftr_loss(result: MatchResult, spv: Supervision,
               expec_f_gt: torch.Tensor, inp: MatchInput, cfg: LossConfig,
               mc: MatchCoarseConfig):
    """Total loss.  Returns (loss, scalars dict)."""
    if result.conf_matrix is None:
        if result.feat_c0 is None:
            raise ValueError("no conf matrix and no coarse features: the "
                             "fused loss needs the matcher's fused route")
        loss_c = _fused_coarse_loss(result, spv, inp, cfg, mc)
    else:
        S = result.conf_matrix.shape[2]
        loss_c = coarse_loss(result.conf_matrix, spv.conf_matrix_gt(S), cfg,
                             mc, weight=compute_c_weight(inp),
                             conf_with_bin=result.conf_matrix_with_bin)
    loss_f = fine_loss(result.expec_f, expec_f_gt, cfg,
                       slot_mask=result.coarse.mask)
    loss = cfg.coarse_weight * loss_c + cfg.fine_weight * loss_f
    return loss, {"loss": loss, "loss_c": loss_c, "loss_f": loss_f}
