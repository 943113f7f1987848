"""Evaluation metrics: epipolar distance, pose error, AUC aggregation
(``loftr_tpu.eval.metrics``; the reference's src/utils/metrics.py).

  - essential matrix from pose and the symmetric epipolar distance
    (metrics.py:30-56): batched tensors on the caller's device;
  - relative pose error (metrics.py:12-27), pose AUC @ {5,10,20} by the
    trapezoid-integrated recall curve (metrics.py:139-156), precision at an
    epipolar threshold (metrics.py:159-170) and ``aggregate_metrics`` with
    identifier dedup (metrics.py:173-193): numpy on the host.

The device functions contract their length-3 axes as a product and two
fused multiply-adds in the input dtype, never through a matrix product: a
TF32 product on the card would move errors across the 5e-4 / 1e-4
precision thresholds (the JAX package pins ``Precision.HIGHEST`` for the
same reason).  Each of these operations rounds once, on the card as on the
CPU, and the chain follows XLA's CPU dot for E p0.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Sequence

import numpy as np
import torch


def skew(t: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrices [t]_x."""
    z = torch.zeros_like(t[..., 0])
    return torch.stack([
        torch.stack([z, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], z, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], z], -1)], -2)


def _fma3(a0, b0, a1, b1, a2, b2):
    """a0 b0 + a1 b1 + a2 b2 as one product and two fused multiply-adds
    (``addcmul`` rounds once on the CPU and on the card), in that order."""
    return torch.addcmul(torch.addcmul(a0 * b0, a1, b1), a2, b2)


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for [..., 3, 3] operands, by :func:`_fma3`."""
    return _fma3(A[..., :, 0, None], B[..., None, 0, :],
                 A[..., :, 1, None], B[..., None, 1, :],
                 A[..., :, 2, None], B[..., None, 2, :])


def apply3(E: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """E x for E [..., 3, 3] and points x [..., M, 3] -> [..., M, 3]."""
    e = E[..., None, :, :]                                   # [..., 1, 3, 3]
    return _fma3(e[..., 0], x[..., 0, None], e[..., 1], x[..., 1, None],
                 e[..., 2], x[..., 2, None])


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of length 3, by :func:`_fma3`."""
    return _fma3(a[..., 0], b[..., 0], a[..., 1], b[..., 1], a[..., 2],
                 b[..., 2])


def homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def essential_from_pose(T_0to1: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R for T_0to1 [B, 4, 4] (metrics.py:55-56)."""
    return matmul3(skew(T_0to1[:, :3, 3]), T_0to1[:, :3, :3])


def symmetric_epipolar_distance(pts0: torch.Tensor, pts1: torch.Tensor,
                                E: torch.Tensor, K0: torch.Tensor,
                                K1: torch.Tensor) -> torch.Tensor:
    """Squared symmetric epipolar distance (metrics.py:30-47).

    pts0, pts1: [B, M, 2] image px; E: [B, 3, 3]; K0, K1: [B, 3, 3].
    Returns [B, M].
    """
    f0 = torch.stack([K0[:, 0, 0], K0[:, 1, 1]], -1)[:, None, :]
    c0 = torch.stack([K0[:, 0, 2], K0[:, 1, 2]], -1)[:, None, :]
    f1 = torch.stack([K1[:, 0, 0], K1[:, 1, 1]], -1)[:, None, :]
    c1 = torch.stack([K1[:, 0, 2], K1[:, 1, 2]], -1)[:, None, :]
    p0h = homogeneous((pts0 - c0) / f0)                        # [B, M, 3]
    p1h = homogeneous((pts1 - c1) / f1)
    Ep0 = apply3(E, p0h)                                       # [B, M, 3]
    Etp1 = apply3(E.transpose(-1, -2), p1h)                    # E^T p1
    p1Ep0 = dot3(p1h, Ep0)
    return p1Ep0 ** 2 * (1.0 / (Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2)
                         + 1.0 / (Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2))


def relative_pose_error(T_0to1: np.ndarray, R: np.ndarray, t: np.ndarray,
                        ignore_gt_t_thr: float = 0.0):
    """(t_err_deg, R_err_deg) (metrics.py:12-27)."""
    t_gt = T_0to1[:3, 3]
    n = np.linalg.norm(t) * np.linalg.norm(t_gt)
    t_err = np.rad2deg(np.arccos(np.clip(np.dot(t, t_gt) / max(n, 1e-15),
                                         -1.0, 1.0)))
    t_err = np.minimum(t_err, 180 - t_err)  # E sign ambiguity
    if np.linalg.norm(t_gt) < ignore_gt_t_thr:
        t_err = 0.0
    R_gt = T_0to1[:3, :3]
    cos = np.clip((np.trace(R.T @ R_gt) - 1) / 2, -1.0, 1.0)
    R_err = np.rad2deg(np.abs(np.arccos(cos)))
    return float(t_err), float(R_err)


def error_auc(errors: Sequence[float],
              thresholds: Sequence[float] = (5, 10, 20)) -> Dict[str, float]:
    """Pose AUC by trapezoid-integrated recall curve (metrics.py:139-156)."""
    errors = [0] + sorted(float(e) for e in errors)
    recall = list(np.linspace(0, 1, len(errors)))
    aucs = {}
    for thr in thresholds:
        last_index = np.searchsorted(errors, thr)
        y = recall[:last_index] + [recall[last_index - 1]]
        x = errors[:last_index] + [thr]
        aucs[f"auc@{int(thr)}"] = float(np.trapezoid(y, x) / thr)
    return aucs


def epidist_prec(errors_per_pair: Sequence[np.ndarray],
                 thresholds: Sequence[float]) -> Dict[str, float]:
    """Mean per-pair precision at epipolar thresholds (metrics.py:159-170)."""
    out = {}
    for thr in thresholds:
        precs = [float(np.mean(errs < thr)) if len(errs) > 0 else 0.0
                 for errs in errors_per_pair]
        out[f"prec@{thr:.0e}"] = float(np.mean(precs)) if precs else 0.0
    return out


def aggregate_metrics(metrics: Dict[str, list],
                      epi_err_thr: float = 5e-4) -> Dict[str, float]:
    """Dataset-level aggregation with identifier dedup (metrics.py:173-193).

    metrics keys: 'identifiers', 'R_errs', 't_errs', 'epi_errs' (list of
    per-pair arrays).
    """
    unq_ids = OrderedDict(
        (iden, idx) for idx, iden in enumerate(metrics["identifiers"]))
    unq_ids = list(unq_ids.values())
    pose_errors = np.max(np.stack([
        np.asarray(metrics["R_errs"], np.float64),
        np.asarray(metrics["t_errs"], np.float64)]), axis=0)[unq_ids]
    aucs = error_auc(pose_errors, (5, 10, 20))
    epi = [np.asarray(metrics["epi_errs"][i]) for i in unq_ids]
    precs = epidist_prec(epi, [epi_err_thr])
    return {**aucs, **precs}
