"""Pose recovery from matches with OpenCV (``loftr_tpu.eval.pose``).

:func:`estimate_pose_opencv` keeps exact parity with the reference's eval
(cv2.findEssentialMat 5-point RANSAC + recoverPose, the reference's
src/utils/metrics.py:72-98) on the host; it reproduces published AUC
numbers.  The batched solvers on the device are in ``eval/ransac.py``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is present in this image
    cv2 = None


def estimate_pose_opencv(kpts0: np.ndarray, kpts1: np.ndarray,
                         K0: np.ndarray, K1: np.ndarray, thresh: float,
                         conf: float = 0.99999
                         ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """5-point RANSAC essential + recoverPose (metrics.py:72-98).

    Returns (R, t, inlier_mask) or None."""
    if cv2 is None or len(kpts0) < 5:
        return None
    kpts0 = (kpts0 - K0[[0, 1], [2, 2]][None]) / K0[[0, 1], [0, 1]][None]
    kpts1 = (kpts1 - K1[[0, 1], [2, 2]][None]) / K1[[0, 1], [0, 1]][None]
    ransac_thr = thresh / np.mean([K0[0, 0], K1[1, 1], K0[0, 0], K1[1, 1]])

    E, mask = cv2.findEssentialMat(kpts0, kpts1, np.eye(3),
                                   threshold=ransac_thr, prob=conf,
                                   method=cv2.RANSAC)
    if E is None:
        return None
    best_num_inliers = 0
    ret = None
    for _E in np.split(E, len(E) / 3):
        n, R, t, _ = cv2.recoverPose(_E, kpts0, kpts1, np.eye(3), 1e9,
                                     mask=mask)
        if n > best_num_inliers:
            ret = (R, t[:, 0], mask.ravel() > 0)
            best_num_inliers = n
    return ret
