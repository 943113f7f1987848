"""Trajectory evaluation: Umeyama Sim(3) alignment + absolute trajectory
error (standard SLAM metric); a numpy copy of ``loftr_tpu.sfm.ate``."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = True
                  ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform aligning est -> gt.

    est, gt: [N, 3] camera centers.  Returns (s, R, t) with
    gt ~ s * R @ est + t.  (Umeyama 1991.)
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(cov)
    Sgn = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Sgn[2, 2] = -1
    R = U @ Sgn @ Vt
    if with_scale:
        var_e = (xe ** 2).sum() / len(est)
        s = float(np.trace(np.diag(D) @ Sgn) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def absolute_trajectory_error(est: np.ndarray, gt: np.ndarray,
                              with_scale: bool = True) -> dict:
    """RMSE/mean/median ATE after Sim(3) alignment.

    est, gt: [N, 3] camera centers (world frame)."""
    s, R, t = align_umeyama(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return {
        "ate_rmse": float(np.sqrt(np.mean(err ** 2))),
        "ate_mean": float(np.mean(err)),
        "ate_median": float(np.median(err)),
        "scale": s,
    }


def camera_centers(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """World camera centers from world->cam poses: c = -R^T t."""
    return -np.einsum("nij,ni->nj", R, t)
