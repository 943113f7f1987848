"""Minimal 5-point essential-matrix solver (hidden-variable resultant).

Clean-room implementation of the classical 5-point relative-pose problem
(Nister 2004 / Stewenius 2006), written from the algebra:

  1. The 5 epipolar constraints give a 4-dim nullspace:
     E(x, y, z) = x E1 + y E2 + z E3 + E4.
  2. E is essential iff det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0
     -> 10 cubic polynomial constraints in (x, y, z).
  3. Hidden-variable trick: group by the 10 monomials in (x, y)
     {x^3, x^2 y, x y^2, y^3, x^2, x y, y^2, x, y, 1}; the coefficients are
     polynomials in z (degrees 0,0,0,0,1,1,1,2,2,3), so the constraints are
     C(z) m(x, y) = 0 with C(z) a 10x10 polynomial matrix.  A solution needs
     det C(z) = 0, and the column degree structure bounds
     deg det C = 4*0 + 3*1 + 2*2 + 1*3 = 10 exactly.
  4. det C(z) is recovered by evaluating at 11 z samples and interpolating;
     its real roots give z; the nullspace of C(z*) gives m, hence (x, y).

All polynomial coefficient extraction is done numerically via Vandermonde
interpolation (no symbolic expansion), which keeps the implementation ~100
lines and exact up to conditioning.

A copy of ``loftr_tpu.eval.five_point`` (host numpy): the minimal solver of
the host RANSAC route ``pose_solver="5pt"``, and the reference the batched
solver on the device (``eval/five_point_batched.py``) is tested against;
that solver also takes its sample points from here.
"""
from __future__ import annotations

from typing import List

import numpy as np

# fixed (x, y) sample points for coefficient interpolation (any generic set)
_RNG = np.random.RandomState(1234)
_XY_SAMPLES = _RNG.randn(10, 2)
_XY_MONOMIALS = None
_Z_SAMPLES = np.linspace(-1.1, 1.3, 11) + 0.0137  # generic, avoids symmetry


def _xy_vandermonde():
    """[10, 10] monomial matrix at the fixed samples; cached inverse."""
    global _XY_MONOMIALS
    if _XY_MONOMIALS is None:
        x = _XY_SAMPLES[:, 0]
        y = _XY_SAMPLES[:, 1]
        V = np.stack([x ** 3, x ** 2 * y, x * y ** 2, y ** 3,
                      x ** 2, x * y, y ** 2, x, y, np.ones_like(x)], axis=1)
        _XY_MONOMIALS = np.linalg.inv(V)
    return _XY_MONOMIALS


def _nullspace4(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """[4, 3, 3] nullspace basis of the 5x9 epipolar constraint matrix."""
    x0, y0 = p0[:, 0], p0[:, 1]
    x1, y1 = p1[:, 0], p1[:, 1]
    A = np.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                  x0, y0, np.ones_like(x0)], axis=1)  # [5, 9]
    _, _, vt = np.linalg.svd(A)
    return vt[5:].reshape(4, 3, 3)


def _constraints_at(basis: np.ndarray, x: float, y: float, z: float
                    ) -> np.ndarray:
    """Evaluate the 10 essential constraints at (x, y, z).  [10]."""
    E = x * basis[0] + y * basis[1] + z * basis[2] + basis[3]
    EEt = E @ E.T
    M = 2.0 * EEt @ E - np.trace(EEt) * E
    return np.concatenate([[np.linalg.det(E)], M.reshape(-1)])


def _C_of_z(basis: np.ndarray, z: float) -> np.ndarray:
    """[10, 10] hidden-variable coefficient matrix at a fixed z."""
    evals = np.stack([
        _constraints_at(basis, sx, sy, z) for sx, sy in _XY_SAMPLES
    ], axis=0)  # [10 samples, 10 constraints]
    # coeffs[m, k] for constraint k: solve V @ coeffs_k = evals[:, k]
    return (_xy_vandermonde() @ evals).T  # [10 constraints, 10 monomials]


def solve_5point(p0: np.ndarray, p1: np.ndarray) -> List[np.ndarray]:
    """All real essential matrices consistent with 5 normalized
    correspondences.  p0, p1: [5, 2].  Returns up to 10 E (3x3, ||E||=1)."""
    basis = _nullspace4(np.asarray(p0, np.float64),
                        np.asarray(p1, np.float64))
    # det C(z) at 11 samples -> degree-10 polynomial coefficients
    dets = np.array([np.linalg.det(_C_of_z(basis, z)) for z in _Z_SAMPLES])
    scale = np.max(np.abs(dets))
    if scale < 1e-30:
        return []
    Vz = np.vander(_Z_SAMPLES, 11)  # columns z^10 .. z^0
    coeffs = np.linalg.solve(Vz, dets / scale)
    roots = np.roots(coeffs)
    out = []
    for r in roots:
        if abs(r.imag) > 1e-6:
            continue
        z = float(r.real)
        C = _C_of_z(basis, z)
        _, s, vt = np.linalg.svd(C)
        m = vt[-1]  # monomial vector [x^3 ... x, y, 1]
        if abs(m[9]) < 1e-12:
            continue
        x = m[7] / m[9]
        y = m[8] / m[9]
        E = x * basis[0] + y * basis[1] + z * basis[2] + basis[3]
        n = np.linalg.norm(E)
        if n < 1e-12:
            continue
        out.append(E / n)
    return out


def estimate_pose_5pt(kpts0: np.ndarray, kpts1: np.ndarray,
                      K0: np.ndarray, K1: np.ndarray,
                      pixel_thr: float = 0.5, num_hypotheses: int = 200,
                      seed: int = 0):
    """Host LO-RANSAC with 5-point minimal hypotheses.

    Same interface as eval/pose.estimate_pose_opencv: returns
    (R, t, inlier_mask) or None."""
    n = len(kpts0)
    if n < 6:
        return None
    p0 = (kpts0 - K0[[0, 1], [2, 2]][None]) / K0[[0, 1], [0, 1]][None]
    p1 = (kpts1 - K1[[0, 1], [2, 2]][None]) / K1[[0, 1], [0, 1]][None]
    thr = pixel_thr / np.mean([K0[0, 0], K0[1, 1], K1[0, 0], K1[1, 1]])
    thr_sq = thr * thr
    rng = np.random.RandomState(seed)

    def sampson(E):
        p0h = np.concatenate([p0, np.ones((n, 1))], 1)
        p1h = np.concatenate([p1, np.ones((n, 1))], 1)
        Ep0 = p0h @ E.T
        Etp1 = p1h @ E
        num = np.sum(p1h * Ep0, 1) ** 2
        den = Ep0[:, 0] ** 2 + Ep0[:, 1] ** 2 + \
            Etp1[:, 0] ** 2 + Etp1[:, 1] ** 2
        return num / np.maximum(den, 1e-15)

    best_E, best_inl = None, -1
    for _ in range(num_hypotheses):
        idx = rng.choice(n, 5, replace=False)
        for E in solve_5point(p0[idx], p1[idx]):
            inl = int((sampson(E) < thr_sq).sum())
            if inl > best_inl:
                best_inl, best_E = inl, E
    if best_E is None or best_inl < 6:
        return None

    # Cauchy-IRLS polish with the (weighted) 8-point refit (same schedule as
    # the other solvers); the minimal solver supplies the basin.
    E_cur = E_fin = best_E
    n_fin = int((sampson(E_fin) < thr_sq).sum())
    for mult in (16.0, 8.0, 4.0, 2.0, 1.0, 1.0):
        e = sampson(E_cur)
        w = 1.0 / (1.0 + e / (thr_sq * mult))
        x0, y0 = p0[:, 0], p0[:, 1]
        x1, y1 = p1[:, 0], p1[:, 1]
        A = np.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                      x0, y0, np.ones(n)], 1) * w[:, None]
        _, _, vt = np.linalg.svd(A, full_matrices=True)
        E_new = vt[-1].reshape(3, 3)
        U, s, Vt = np.linalg.svd(E_new)
        E_cur = U @ np.diag([1.0, 1.0, 0.0]) @ Vt
        n_new = int((sampson(E_cur) < thr_sq).sum())
        if n_new >= n_fin:
            n_fin, E_fin = n_new, E_cur
    inliers = sampson(E_fin) < thr_sq

    # pose recovery: decompose + cheirality voting
    U, _, Vt = np.linalg.svd(E_fin)
    U *= np.sign(np.linalg.det(U))
    Vt *= np.sign(np.linalg.det(Vt))
    W = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    cands = [(U @ W @ Vt, U[:, 2]), (U @ W @ Vt, -U[:, 2]),
             (U @ W.T @ Vt, U[:, 2]), (U @ W.T @ Vt, -U[:, 2])]
    x0h = np.concatenate([p0, np.ones((n, 1))], 1)
    x1h = np.concatenate([p1, np.ones((n, 1))], 1)
    best = None
    best_votes = -1
    for R, t in cands:
        Rx0 = x0h @ R.T
        a11 = np.sum(Rx0 * Rx0, 1)
        a12 = -np.sum(Rx0 * x1h, 1)
        a22 = np.sum(x1h * x1h, 1)
        b1 = -Rx0 @ t
        b2 = x1h @ t
        det = np.where(np.abs(a11 * a22 - a12 ** 2) < 1e-15, 1e-15,
                       a11 * a22 - a12 ** 2)
        z0 = (b1 * a22 - b2 * a12) / det
        z1 = (a11 * b2 - a12 * b1) / det
        votes = int(((z0 > 0) & (z1 > 0) & inliers).sum())
        if votes > best_votes:
            best_votes, best = votes, (R, t)
    R, t = best
    return R, t, inliers
