"""Coarse matching: dual-softmax confidence and static-capacity selection.

The inference half of ``loftr_tpu.ops.matching``: the plain
``dual_softmax_conf`` + ``mutual_nearest_candidates`` path, the kernel path
``kernel_mutual_nearest_candidates`` (the JAX package's
``pallas_mutual_nearest_candidates``), fixed-capacity ``topk_matches`` and
``matches_to_kpts``.  Training selection and Sinkhorn wait for later slices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from loftr_tpu_torch.structs import CoarseMatches

INF = 1e9


def dual_softmax_conf(feat0: torch.Tensor, feat1: torch.Tensor,
                      temperature: float,
                      mask0: Optional[torch.Tensor] = None,
                      mask1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conf [B, L, S] = softmax_rows(sim) * softmax_cols(sim), with
    sim = (f0/sqrt(C)) . (f1/sqrt(C)) / T (the reference's
    coarse_matching.py:112-119)."""
    c = feat0.shape[-1]
    scale = 1.0 / c ** 0.5
    sim = torch.einsum("blc,bsc->bls", (feat0 * scale).float(),
                       (feat1 * scale).float()) / temperature
    if mask0 is not None:
        pair = mask0[:, :, None].bool() & mask1[:, None, :].bool()
        sim = torch.where(pair, sim, torch.full_like(sim, -INF))
    return torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2)


def _border_row_mask(hc: int, wc: int, border: int,
                     pad_mask: Optional[torch.Tensor], device) -> torch.Tensor:
    """[B-or-1, hc*wc] bool: cells allowed as matches after border removal
    (mask_border / mask_border_with_padding of the reference)."""
    ys = torch.arange(hc, device=device)[:, None]
    xs = torch.arange(wc, device=device)[None, :]
    if border <= 0:
        if pad_mask is None:
            return torch.ones((1, hc * wc), dtype=torch.bool, device=device)
        return pad_mask.reshape(pad_mask.shape[0], hc * wc).bool()
    if pad_mask is None:
        ok = (ys >= border) & (ys < hc - border) & \
             (xs >= border) & (xs < wc - border)
        return ok.reshape(1, hc * wc)
    pm = pad_mask.to(torch.int32)
    h_eff = pm.sum(dim=1).amax(dim=-1)
    w_eff = pm.sum(dim=2).amax(dim=-1)
    ok = (ys[None] >= border) & (ys[None] < (h_eff - border)[:, None, None]) & \
         (xs[None] >= border) & (xs[None] < (w_eff - border)[:, None, None])
    ok = ok & pad_mask.bool()
    return ok.reshape(ok.shape[0], hc * wc)


class CandidateMatches(NamedTuple):
    """Per-row best matches before capacity selection."""
    j_ids: torch.Tensor   # [B, L] best column per row
    mconf: torch.Tensor   # [B, L] its confidence
    valid: torch.Tensor   # [B, L] passes thr + border + MNN


def mutual_nearest_candidates(conf: torch.Tensor, thr: float, border_rm: int,
                              hw0_c: tuple, hw1_c: tuple,
                              mask0: Optional[torch.Tensor] = None,
                              mask1: Optional[torch.Tensor] = None,
                              ) -> CandidateMatches:
    """Threshold + border removal + mutual-nearest filtering on [B, L, S]."""
    row_ok = _border_row_mask(hw0_c[0], hw0_c[1], border_rm, mask0,
                              conf.device)
    col_ok = _border_row_mask(hw1_c[0], hw1_c[1], border_rm, mask1,
                              conf.device)
    row_max = conf.amax(dim=2, keepdim=True)
    col_max = conf.amax(dim=1, keepdim=True)
    mask = (conf > thr) & (conf >= row_max) & (conf >= col_max)
    mask = mask & row_ok[:, :, None] & col_ok[:, None, :]
    masked_conf = torch.where(mask, conf, torch.full_like(conf, -1.0))
    j_ids = masked_conf.argmax(dim=2).to(torch.int32)
    valid = mask.any(dim=2)
    mconf = torch.gather(conf, 2, j_ids[:, :, None].long())[..., 0]
    mconf = torch.where(valid, mconf, torch.zeros_like(mconf))
    return CandidateMatches(j_ids=j_ids, mconf=mconf, valid=valid)


def kernel_mutual_nearest_candidates(
        feat0: torch.Tensor, feat1: torch.Tensor, temperature: float,
        thr: float, border_rm: int, hw0_c: tuple, hw1_c: tuple,
        mask0: Optional[torch.Tensor] = None,
        mask1: Optional[torch.Tensor] = None) -> CandidateMatches:
    """CandidateMatches through the dual-softmax kernel module: the same
    function as dual_softmax_conf + mutual_nearest_candidates without the
    [L, S] matrix on the CUDA path.  feat0/feat1: [B, L/S, C]."""
    from loftr_tpu_torch.ops.kernels.dual_softmax import \
        fused_dual_softmax_match

    B, L, _ = feat0.shape
    S = feat1.shape[1]
    m0 = None if mask0 is None else mask0.reshape(B, L)
    m1 = None if mask1 is None else mask1.reshape(B, S)
    best_val, best_j, colconf = fused_dual_softmax_match(
        feat0, feat1, temperature, m0, m1)

    row_ok = _border_row_mask(hw0_c[0], hw0_c[1], border_rm, mask0,
                              feat0.device).expand(B, L)
    col_ok = _border_row_mask(hw1_c[0], hw1_c[1], border_rm, mask1,
                              feat0.device).expand(B, S)
    jl = best_j.long()
    valid = (best_val > thr) & row_ok & torch.gather(col_ok, 1, jl) & \
        (best_val >= torch.gather(colconf, 1, jl))
    mconf = torch.where(valid, best_val, torch.zeros_like(best_val))
    return CandidateMatches(j_ids=best_j, mconf=mconf, valid=valid)


def topk_matches(cand: CandidateMatches, k: int) -> CoarseMatches:
    """Top-k candidates by confidence.  A stable descending sort, so ties
    (every invalid slot scores -1) keep the lowest index first, as
    jax.lax.top_k does."""
    score = torch.where(cand.valid, cand.mconf,
                        torch.full_like(cand.mconf, -1.0))
    top_conf, i_ids = torch.sort(score, dim=1, descending=True, stable=True)
    top_conf, i_ids = top_conf[:, :k], i_ids[:, :k]
    j_ids = torch.gather(cand.j_ids, 1, i_ids)
    mask = top_conf > 0.0
    mconf = torch.where(mask, top_conf, torch.zeros_like(top_conf))
    return CoarseMatches(i_ids=i_ids.to(torch.int32),
                         j_ids=j_ids.to(torch.int32), mconf=mconf, mask=mask,
                         gt_mask=torch.zeros_like(mask))


def matches_to_kpts(matches: CoarseMatches, hw0_c: tuple, hw1_c: tuple,
                    stride: int, scale0: Optional[torch.Tensor] = None,
                    scale1: Optional[torch.Tensor] = None):
    """Coarse cell ids -> keypoints (x, y) in original pixels, [B, K, 2]."""
    w0, w1 = hw0_c[1], hw1_c[1]
    i_ids, j_ids = matches.i_ids.long(), matches.j_ids.long()
    kpts0 = torch.stack([(i_ids % w0).float(), (i_ids // w0).float()],
                        dim=-1) * stride
    kpts1 = torch.stack([(j_ids % w1).float(), (j_ids // w1).float()],
                        dim=-1) * stride
    if scale0 is not None:
        kpts0 = kpts0 * scale0[:, None, :]
    if scale1 is not None:
        kpts1 = kpts1 * scale1[:, None, :]
    return kpts0, kpts1
