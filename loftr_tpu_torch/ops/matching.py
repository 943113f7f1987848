"""Coarse matching: confidence matrices and static-capacity selection.

``loftr_tpu.ops.matching``: the plain ``dual_softmax_conf`` /
``sinkhorn_conf`` + ``mutual_nearest_candidates`` paths, the kernel paths
``kernel_mutual_nearest_candidates`` and ``kernel_sinkhorn_candidates`` (the
JAX package's ``pallas_mutual_nearest_candidates`` and
``pallas_sinkhorn_candidates``), fixed-capacity ``topk_matches``, the
training selection ``select_train_matches`` with ``mask_match_budget``, and
``matches_to_kpts``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from loftr_tpu_torch.ops.sinkhorn import log_optimal_transport
from loftr_tpu_torch.parallel.comm import batch_total, data_group
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


def sinkhorn_conf(feat0: torch.Tensor, feat1: torch.Tensor,
                  bin_score: torch.Tensor, iters: int,
                  mask0: Optional[torch.Tensor] = None,
                  mask1: Optional[torch.Tensor] = None,
                  prefilter: bool = False):
    """Sinkhorn-OT confidence (the reference's coarse_matching.py:121-143).

    Returns (conf [B, L, S], assign_with_bin [B, L+1, S+1]).  ``prefilter``
    zeroes the rows and columns whose argmax in the full assignment is the
    dustbin (evaluation only in the reference)."""
    c = feat0.shape[-1]
    scale = 1.0 / c ** 0.5
    sim = torch.einsum("blc,bsc->bls", (feat0 * scale).float(),
                       (feat1 * scale).float())
    if mask0 is not None:
        pair = mask0[:, :, None].bool() & mask1[:, None, :].bool()
        sim = torch.where(pair, sim, torch.full_like(sim, -INF))
    assign = torch.exp(log_optimal_transport(sim, bin_score, iters))
    conf = assign[:, :-1, :-1]
    if prefilter:
        L, S = conf.shape[1], conf.shape[2]
        filt0 = assign.argmax(dim=2)[:, :-1] == S            # [B, L]
        filt1 = assign.argmax(dim=1)[:, :-1] == L            # [B, S]
        conf = conf.masked_fill(filt0[:, :, None] | filt1[:, None, :], 0.0)
    return conf, assign


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


def _candidates_from_best(best_val, best_j, colconf, thr: float,
                          border_rm: int, hw0_c: tuple, hw1_c: tuple,
                          mask0, mask1) -> CandidateMatches:
    """The epilogue both matching kernels share: per-row best value and
    column, per-column maximum -> threshold, border and mutual-nearest
    tests."""
    B, L = best_val.shape
    S = colconf.shape[1]
    dev = best_val.device
    row_ok = _border_row_mask(hw0_c[0], hw0_c[1], border_rm, mask0,
                              dev).expand(B, L)
    col_ok = _border_row_mask(hw1_c[0], hw1_c[1], border_rm, mask1,
                              dev).expand(B, S)
    jl = best_j.long()
    valid = (best_val > thr) & row_ok & torch.gather(col_ok, 1, jl) & \
        (best_val >= torch.gather(colconf, 1, jl))
    mconf = torch.where(valid, best_val, torch.zeros_like(best_val))
    return CandidateMatches(j_ids=best_j, mconf=mconf, valid=valid)


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
    return _candidates_from_best(best_val, best_j, colconf, thr, border_rm,
                                 hw0_c, hw1_c, mask0, mask1)


def kernel_sinkhorn_candidates(
        feat0: torch.Tensor, feat1: torch.Tensor, bin_score: torch.Tensor,
        iters: int, thr: float, border_rm: int, hw0_c: tuple, hw1_c: tuple,
        mask0: Optional[torch.Tensor] = None,
        mask1: Optional[torch.Tensor] = None,
        prefilter: bool = False) -> CandidateMatches:
    """CandidateMatches through the Sinkhorn kernel module: the same
    function as sinkhorn_conf + mutual_nearest_candidates without the
    coupling matrix on the CUDA path; ``prefilter`` applies the
    skh_prefilter rule exactly (one more pass in the kernel)."""
    from loftr_tpu_torch.ops.kernels.sinkhorn import fused_sinkhorn_match

    B, L, _ = feat0.shape
    S = feat1.shape[1]
    m0 = None if mask0 is None else mask0.reshape(B, L)
    m1 = None if mask1 is None else mask1.reshape(B, S)
    best_val, best_j, colconf, _, _ = fused_sinkhorn_match(
        feat0, feat1, bin_score, iters, m0, m1, prefilter=prefilter)
    return _candidates_from_best(best_val, best_j, colconf, thr, border_rm,
                                 hw0_c, hw1_c, mask0, mask1)


def _top_k(score: torch.Tensor, k: int):
    """(values, indices) of the k largest along dim 1.  A stable descending
    sort, so ties keep the lowest index first, as jax.lax.top_k does
    (torch.topk does not promise that)."""
    val, idx = torch.sort(score, dim=1, descending=True, stable=True)
    return val[:, :k], idx[:, :k]


def topk_matches(cand: CandidateMatches, k: int) -> CoarseMatches:
    """Top-k candidates by confidence; every invalid slot scores -1 and
    ties with the others, so those come out in index order."""
    score = torch.where(cand.valid, cand.mconf,
                        torch.full_like(cand.mconf, -1.0))
    top_conf, i_ids = _top_k(score, k)
    j_ids = torch.gather(cand.j_ids, 1, i_ids)
    mask = top_conf > 0.0
    mconf = torch.where(mask, top_conf, torch.zeros_like(top_conf))
    return CoarseMatches(i_ids=i_ids.to(torch.int32),
                         j_ids=j_ids.to(torch.int32), mconf=mconf, mask=mask,
                         gt_mask=torch.zeros_like(mask))


def mask_match_budget(mask0: torch.Tensor, mask1: torch.Tensor,
                      percent: float) -> torch.Tensor:
    """Per-pair train-match budget from the padding masks: percent times
    the smaller of the two masks' effective extents (largest column sum
    times largest row sum).  mask0/mask1: [B, hc, wc] bool.  Returns
    int32 [B]."""
    def extent(m):
        mi = m.to(torch.int32)
        return mi.sum(dim=1).amax(dim=-1) * mi.sum(dim=2).amax(dim=-1)
    cand = torch.minimum(extent(mask0), extent(mask1))
    return torch.floor(percent * cand.float()).to(torch.int32)


# the uniform arrays each sampling mode consumes, in the order drawn
SELECT_NOISE = {
    "per_pair": ("pred", "gt_sel", "gt_pick"),
    "global_replacement": ("quota", "shuffle", "pick", "gt_sel", "gt_pick"),
}


def draw_select_noise(B: int, L: int, k_train: int, sampling: str,
                      generator: Optional[torch.Generator], device) -> dict:
    """The uniform draws select_train_matches consumes, by name: priorities
    in [0.1, 1) for "pred"/"shuffle"/"gt_sel" [B, L], picks in [0, 1) for
    "pick"/"gt_pick" [B, k_train] and "quota" [B]."""
    shapes = {"pred": (B, L), "shuffle": (B, L), "gt_sel": (B, L),
              "pick": (B, k_train), "gt_pick": (B, k_train), "quota": (B,)}
    out = {}
    for name in SELECT_NOISE[sampling]:
        u = torch.rand(shapes[name], generator=generator, device=device)
        if name in ("pred", "shuffle", "gt_sel"):
            u = 0.1 + 0.9 * u
        out[name] = u
    return out


def select_train_matches(cand: CandidateMatches, gt_j: torch.Tensor,
                         gt_valid: torch.Tensor,
                         generator: Optional[torch.Generator], k_train: int,
                         pad_num_gt_min: int,
                         budget: Optional[torch.Tensor] = None,
                         sampling: str = "per_pair",
                         noise: Optional[dict] = None) -> CoarseMatches:
    """Training-time selection with GT padding.

    Keeps at most ``k_train - pad_num_gt_min`` random predicted matches and
    fills the remaining slots with random GT positives (with replacement,
    conf 0).  All k_train slots are populated, so the fine stage sees a
    full static batch.  A pair with no GT gets dummy (0, 0) entries.

    gt_j/gt_valid: [B, L] per-row GT partners.  budget: optional int32 [B]
    (:func:`mask_match_budget`); slots beyond it get mask=False.
    sampling: 'per_pair' draws each pair's predicted slots without
    replacement from that pair's candidates; 'global_replacement' gives
    each pair a quota proportional to its share of the batch's candidates
    and draws with replacement.

    The random numbers come from ``generator`` (on the candidates' device),
    or from ``noise``: the pre-drawn uniform arrays of
    :func:`draw_select_noise`, which lets a test feed the numbers another
    framework drew.

    Inside ``parallel.comm.data_parallel`` the batch is the global one, as
    under JAX's data-sharded mesh: the noise is drawn (or given) at the
    global batch's shape and each rank takes its rows, and
    'global_replacement' shares the slots out over the global batch's
    candidates.  N ranks then select what one process selects on the
    concatenated batch with the same generator.
    """
    B, L = cand.valid.shape
    dev = cand.valid.device
    k_pred_max = k_train - pad_num_gt_min
    if k_pred_max <= 0:
        raise ValueError("pad_num_gt_min must be < k_train")
    dg = data_group()
    b_all = B if dg is None else dg.global_rows
    if noise is None:
        noise = draw_select_noise(b_all, L, k_train, sampling, generator,
                                  dev)
    if dg is not None:
        noise = {k: dg.local(v) for k, v in noise.items()}

    slot = torch.arange(k_train, device=dev)[None, :]
    if budget is None:
        eff = torch.full((B, 1), k_train, dtype=torch.int32, device=dev)
        eff_pred = torch.full((B, 1), k_pred_max, dtype=torch.int32,
                              device=dev)
    else:
        eff = budget.clamp(pad_num_gt_min + 1, k_train)[:, None]
        eff_pred = eff - pad_num_gt_min
    neg1 = torch.full((), -1.0, device=dev)

    if sampling == "global_replacement":
        n_cand = cand.valid.sum(dim=1)                         # [B]
        total = batch_total(n_cand.sum()).clamp_min(1)
        expect = (b_all * k_pred_max) * n_cand / total
        quota = torch.floor(expect + noise["quota"]).to(torch.int32)
        eff_pred = torch.minimum(quota[:, None], eff_pred)
        cpri = torch.where(cand.valid, noise["shuffle"], neg1)
        _, corder = _top_k(cpri, L)                            # valid first
        pick = torch.floor(noise["pick"] * n_cand.clamp_min(1)[:, None]
                           ).long().clamp(0, L - 1)
        pred_order = torch.gather(corder, 1, pick)
        pred_take = (n_cand[:, None] > 0) & (slot < eff_pred)
    elif sampling == "per_pair":
        pri = torch.where(cand.valid, noise["pred"], neg1)
        _, pred_order = _top_k(pri, k_train)                   # [B, k_train]
        pred_valid = torch.gather(cand.valid, 1, pred_order)
        pred_take = pred_valid & (slot < eff_pred)
    else:
        raise ValueError(sampling)
    pred_i = pred_order.to(torch.int32)
    pred_j = torch.gather(cand.j_ids, 1, pred_order).to(torch.int32)
    pred_conf = torch.gather(cand.mconf, 1, pred_order)

    # GT pool: valid GT rows first, in random order; picks with replacement
    gpri = torch.where(gt_valid, noise["gt_sel"], neg1)
    _, gt_order = _top_k(gpri, L)
    n_gt = gt_valid.sum(dim=1)
    pick = torch.floor(noise["gt_pick"] * n_gt.clamp_min(1)[:, None]
                       ).long().clamp(0, L - 1)
    gt_rows = torch.gather(gt_order, 1, pick)
    gt_cols = torch.gather(gt_j.long(), 1, gt_rows)
    has_gt = (n_gt > 0)[:, None]
    gt_rows = torch.where(has_gt, gt_rows, torch.zeros_like(gt_rows))
    gt_cols = torch.where(has_gt, gt_cols, torch.zeros_like(gt_cols))

    i_ids = torch.where(pred_take, pred_i, gt_rows.to(torch.int32))
    j_ids = torch.where(pred_take, pred_j, gt_cols.to(torch.int32))
    mconf = torch.where(pred_take, pred_conf, torch.zeros_like(pred_conf))
    mask = (slot < eff).expand(B, k_train)
    return CoarseMatches(i_ids=i_ids, j_ids=j_ids, mconf=mconf, mask=mask,
                         gt_mask=mask & ~pred_take)


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
