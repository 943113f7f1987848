"""End-to-end SfM over a keyframed sequence (``loftr_tpu.sfm.pipeline``).

frames -> keyframe selection -> pairwise matching (LoFTR) -> per-edge RANSAC
pose (+ metric scale from depth when available) -> chained pose-graph init ->
union-find tracks -> triangulation -> Schur-complement BA -> trajectory.

The matcher is injected as a callable so the pipeline is testable with a
synthetic oracle and runnable with the real LoFTR matcher.  The per-edge
RANSAC and the BA run on ``device`` (CUDA unless the caller passes
``device="cpu"``); the pose graph, tracks and problem build are host code,
as in JAX.  Each edge's RANSAC samples are drawn on the host by
:func:`draw_samples` from a CPU ``torch.Generator`` seeded by ``seed``, in
edge order, so a card run and a CPU run of one sequence score the same
hypotheses.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from loftr_tpu_torch.api import resolve_device
from loftr_tpu_torch.eval.ransac import draw_samples, ransac_from_samples
from loftr_tpu_torch.sfm.bundle_adjustment import (BAProblem, bundle_adjust,
                                                   reset_point_outliers)
from loftr_tpu_torch.sfm.pose_graph import (Edge, build_tracks,
                                            chain_world_poses,
                                            metric_scale_from_depth,
                                            triangulate_pair)
from loftr_tpu_torch.utils.profiler import RegionProfiler

# the JAX pipeline's per-edge estimator: estimate_pose_ransac_jax's defaults
RANSAC_HYPOTHESES = 512
RANSAC_SOLVER = "8pt"


def select_keyframes(n_frames: int, stride: int = 5) -> List[int]:
    """Fixed-stride keyframing."""
    return list(range(0, n_frames, stride))


def select_keyframes_adaptive(n_frames: int, match_fn: Callable,
                              min_matches: int = 300,
                              max_gap: int = 30,
                              min_gap: int = 2) -> List[int]:
    """Match-count-adaptive keyframing: advance from the last keyframe until
    the match count to the candidate frame drops below ``min_matches`` (or
    ``max_gap`` is hit), then promote the previous frame.  Guarantees
    consecutive keyframes stay well-matched for the pose graph."""
    kfs = [0]
    while kfs[-1] < n_frames - 1:
        last = kfs[-1]
        chosen = min(last + max_gap, n_frames - 1)
        for cand in range(last + min_gap, min(last + max_gap,
                                              n_frames - 1) + 1):
            k0, _, _, _ = match_fn(last, cand)
            if len(k0) < min_matches:
                chosen = max(cand - 1, last + min_gap)
                break
        chosen = max(chosen, last + 1)
        kfs.append(min(chosen, n_frames - 1))
    return kfs


def _normalize(kpts: np.ndarray, K: np.ndarray) -> np.ndarray:
    return (kpts - K[[0, 1], [2, 2]][None]) / K[[0, 1], [0, 1]][None]


def build_edges(keyframes: Sequence[int], match_fn: Callable,
                K: np.ndarray,
                depths: Optional[Sequence[np.ndarray]] = None,
                link_range: int = 2,
                generator: Optional[torch.Generator] = None,
                min_matches: int = 16,
                pixel_thr: float = 1.0, device="cuda",
                profiler=None) -> List[Edge]:
    """Match keyframe pairs within ``link_range`` and estimate edge poses.

    match_fn(a, b) -> (kpts_a [M,2], kpts_b [M,2], cells_a [M], cells_b [M])
    in pixel coordinates, already filtered to valid matches.
    depths[k]: depth map of keyframe k (for metric scale), or None.
    generator: the CPU generator of the RANSAC draws (seed 0 if None).
    profiler: a ``utils.profiler.RegionProfiler`` timing each match call
    ("sfm/match") and each edge's RANSAC ("sfm/ransac"), or None.
    """
    dev = resolve_device(device)
    prof = profiler or RegionProfiler(enabled=False)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    Kd = torch.as_tensor(K, dtype=torch.float32, device=dev)[None]
    edges: List[Edge] = []
    for ai in range(len(keyframes)):
        for bi in range(ai + 1, min(ai + 1 + link_range, len(keyframes))):
            a, b = keyframes[ai], keyframes[bi]
            with prof.profile("sfm/match"):
                k0, k1, c0, c1 = match_fn(a, b)
            if len(k0) < min_matches:
                continue
            cap = max(64, 1 << int(np.ceil(np.log2(len(k0)))))
            pad0 = np.zeros((1, cap, 2), np.float32)
            pad1 = np.zeros((1, cap, 2), np.float32)
            pad0[0, : len(k0)] = k0
            pad1[0, : len(k1)] = k1
            valid = torch.zeros((1, cap), dtype=torch.bool)
            valid[0, : len(k0)] = True
            samples = draw_samples(valid, RANSAC_HYPOTHESES, RANSAC_SOLVER,
                                   generator)
            with prof.profile("sfm/ransac"):
                est = ransac_from_samples(
                    torch.from_numpy(pad0).to(dev),
                    torch.from_numpy(pad1).to(dev), Kd, Kd, valid.to(dev),
                    samples.to(dev), pixel_thr=pixel_thr,
                    solver=RANSAC_SOLVER)
                ok = bool(est.ok[0])
                n_inl = int(est.num_inliers[0])
                R = est.R[0].cpu().numpy().astype(np.float64)
                t = est.t[0].cpu().numpy().astype(np.float64)
                inl = est.inliers[0].cpu().numpy()[: len(k0)]
            if not ok or n_inl < min_matches:
                continue

            # metric scale from depth (RGB-D): triangulated vs measured z
            if depths is not None and depths[ai] is not None:
                n0 = _normalize(k0[inl], K)
                n1 = _normalize(k1[inl], K)
                _, z_tri = triangulate_pair(R, t, n0, n1)
                pix = np.round(k0[inl]).astype(int)
                h, w = depths[ai].shape
                pix[:, 0] = np.clip(pix[:, 0], 0, w - 1)
                pix[:, 1] = np.clip(pix[:, 1], 0, h - 1)
                z_meas = depths[ai][pix[:, 1], pix[:, 0]]
                s = metric_scale_from_depth(z_tri, z_meas)
                if s is not None and s > 0:
                    t = t * s
            edges.append(Edge(i=ai, j=bi, R=R, t=t,
                              kpts_i=k0[inl], kpts_j=k1[inl],
                              cells_i=c0[inl], cells_j=c1[inl]))
    return edges


def build_ba_problem(n_kf: int, edges: List[Edge], K: np.ndarray,
                     R_w: np.ndarray, t_w: np.ndarray,
                     max_obs: int = 8, device="cuda",
                     tracks: Optional[list] = None) -> Optional[BAProblem]:
    """Tracks -> triangulated landmarks -> static-shape BAProblem on
    ``device``.  tracks: ``build_tracks(edges, max_obs)``, built here when
    not given."""
    dev = resolve_device(device)
    if tracks is None:
        tracks = build_tracks(edges, max_obs_per_track=max_obs)
    if not tracks:
        return None
    P = len(tracks)
    obs_cam = np.zeros((P, max_obs), np.int64)
    obs_uv = np.zeros((P, max_obs, 2), np.float32)
    obs_w = np.zeros((P, max_obs), np.float32)
    points = np.zeros((P, 3), np.float64)
    keep = np.zeros(P, bool)
    for p, track in enumerate(tracks):
        # triangulate from the first two observations
        (fa, ka), (fb, kb) = track[0], track[1]
        Rrel = R_w[fb] @ R_w[fa].T
        trel = t_w[fb] - Rrel @ t_w[fa]
        X_a, z = triangulate_pair(Rrel, trel, _normalize(ka[None], K),
                                  _normalize(kb[None], K))
        if z[0] <= 0.05:
            continue
        # to world: X_w = R_a^T (X_a - t_a)
        points[p] = R_w[fa].T @ (X_a[0] - t_w[fa])
        keep[p] = True
        for o, (f, kp) in enumerate(track[:max_obs]):
            obs_cam[p, o] = f
            obs_uv[p, o] = _normalize(kp[None], K)[0]
            obs_w[p, o] = 1.0
    if keep.sum() == 0:
        return None
    fix = np.zeros(n_kf, bool)
    fix[0] = True
    sel = np.nonzero(keep)[0]

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    return BAProblem(
        R=put(R_w, torch.float32), t=put(t_w, torch.float32),
        points=put(points[sel], torch.float32),
        obs_uv=put(obs_uv[sel], torch.float32),
        obs_cam=put(obs_cam[sel], torch.int64),
        obs_w=put(obs_w[sel], torch.float32),
        fix_mask=put(fix, torch.bool))


def run_sfm(n_frames: int, match_fn: Callable, K: np.ndarray,
            depths: Optional[Sequence[np.ndarray]] = None,
            keyframe_stride: int = 5, link_range: int = 2,
            ba_iters: int = 15, seed: int = 0,
            adaptive_keyframes: bool = False, min_matches_kf: int = 300,
            huber_delta: float = 0.002, ba_solver: str = "dense",
            device="cuda", profiler=None):
    """Full pipeline.  Returns dict with keyframes, poses (R, t world->cam,
    numpy), edges, BA cost, and the solved BAProblem (or None).

    huber_delta > 0 runs an annealed robust BA schedule (Huber at 10 delta,
    then 2.5 delta, the outlier reset at 2.5 delta, then Tukey at delta) -
    the right default for real matcher output.  ba_solver: 'dense' (exact
    reduced-system solve, keyframe scale) or 'pcg' (matrix-free, for large
    keyframe counts).  seed: the RANSAC draws' CPU generator.  profiler: a
    ``utils.profiler.RegionProfiler`` timing the stages (edges with each
    match call and RANSAC, tracks, the problem build, each BA round), or
    None."""
    dev = resolve_device(device)
    prof = profiler or RegionProfiler(enabled=False)
    if adaptive_keyframes:
        kfs = select_keyframes_adaptive(n_frames, match_fn,
                                        min_matches=min_matches_kf)
    else:
        kfs = select_keyframes(n_frames, keyframe_stride)
    kf_depths = None if depths is None else [depths[k] for k in kfs]
    with prof.profile("sfm/edges"):
        edges = build_edges(kfs, match_fn, K, kf_depths, link_range,
                            torch.Generator().manual_seed(seed), device=dev,
                            profiler=prof)
    with prof.profile("sfm/tracks"):
        R_w, t_w = chain_world_poses(len(kfs), edges)
        tracks = build_tracks(edges)
    with prof.profile("sfm/problem"):
        prob = build_ba_problem(len(kfs), edges, K, R_w, t_w, device=dev,
                                tracks=tracks)
    cost = None
    if prob is not None:
        if huber_delta > 0:
            with prof.profile("sfm/ba_huber_10"):
                prob, _ = bundle_adjust(prob, max_iters=ba_iters,
                                        huber_delta=huber_delta * 10,
                                        solver=ba_solver)
            with prof.profile("sfm/ba_huber_2.5"):
                prob, _ = bundle_adjust(prob, max_iters=ba_iters,
                                        huber_delta=huber_delta * 2.5,
                                        solver=ba_solver)
            # outlier-vs-reset: retriangulate points from gated inlier
            # observations so Tukey doesn't reject good observations of
            # points an early outlier dragged off
            with prof.profile("sfm/reset_outliers"):
                prob = reset_point_outliers(prob, huber_delta * 2.5)
            with prof.profile("sfm/ba_tukey"):
                prob, cost = bundle_adjust(prob, max_iters=ba_iters,
                                           huber_delta=huber_delta,
                                           kernel="tukey", solver=ba_solver)
        else:
            with prof.profile("sfm/ba"):
                prob, cost = bundle_adjust(prob, max_iters=ba_iters,
                                           solver=ba_solver)
        R_w = prob.R.cpu().numpy().astype(np.float64)
        t_w = prob.t.cpu().numpy().astype(np.float64)
    return {
        "keyframes": kfs,
        "R": R_w, "t": t_w,
        "edges": edges,
        "ba_cost": cost,
        "problem": prob,
    }
