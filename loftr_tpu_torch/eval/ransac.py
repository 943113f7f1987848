"""Batched RANSAC essential-matrix estimation and pose recovery on the
device (``loftr_tpu.eval.ransac``; the reference calls
cv2.findEssentialMat/recoverPose per pair on the host, metrics.py:83-93).

Every pair of a batch and every hypothesis run at once, over static shapes:
matches are [B, K] with a validity mask (invalid rows get no samples and no
score), hypotheses are [B, H].  Per pair:

  - H hypotheses from sampled matches: weighted 8-point solves (``"8pt"``)
    or the minimal 5-point solver (``"5pt"``, eval/five_point_batched.py,
    up to 10 essential matrices a sample);
  - each scored by its inlier count under the squared Sampson distance; the
    best is the first maximum, as ``jnp.argmax`` takes it;
  - local optimisation by IRLS with annealed Cauchy weights, keeping the
    best model by inlier count seen at any round;
  - pose from the decomposition of E with the cheirality vote.

Sampling (:func:`draw_samples`, an explicit ``torch.Generator``) is apart
from the estimator (:func:`ransac_from_samples`), so the same samples can be
fed to this estimator and to the JAX package's.  The length-3 contractions
are elementwise products and sums in the input dtype, never a TF32 product
(the JAX package pins ``Precision.HIGHEST`` here for the same reason).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from loftr_tpu_torch.eval.metrics import apply3, dot3, homogeneous, matmul3

# minimal sample size of each hypothesis solver
SAMPLE_SIZE = {"8pt": 8, "5pt": 5}
# fewest valid matches a pair needs for an estimate
MIN_MATCHES = {"8pt": 8, "5pt": 6}
# the Cauchy scale schedule of the local optimisation, in units of thr^2
LO_SCHEDULE = (16.0, 8.0, 4.0, 2.0, 1.0, 1.0)


class PoseEstimate(NamedTuple):
    R: torch.Tensor            # [B, 3, 3]
    t: torch.Tensor            # [B, 3]
    E: torch.Tensor            # [B, 3, 3]
    inliers: torch.Tensor      # [B, K] bool
    num_inliers: torch.Tensor  # [B]
    ok: torch.Tensor           # [B] bool: enough valid matches
    best: torch.Tensor         # [B] index of the best hypothesis


def normalize(kpts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel -> normalized camera coords. kpts [B, K, 2], K [B, 3, 3]."""
    f = torch.stack([K[:, 0, 0], K[:, 1, 1]], -1)[:, None]
    c = torch.stack([K[:, 0, 2], K[:, 1, 2]], -1)[:, None]
    return (kpts - c) / f


def det3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of [..., 3, 3]."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def epipolar_rows(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Rows of p1^T E p0 = 0 in E's row-major entries: [..., n, 9]."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    return torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                        x0, y0, torch.ones_like(x0)], -1)


def project_essential(E: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix, singular values (1, 1, 0)."""
    u, _, vt = torch.linalg.svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return matmul3(u * d, vt)


def eight_point(p0: torch.Tensor, p1: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point: E minimising ||A e|| over [..., n, 2] points with
    weights [..., n], projected onto the essential manifold.  [..., 3, 3]."""
    A = epipolar_rows(p0, p1) * w[..., None]
    # the right singular vectors; full_matrices only where n < 9 leaves the
    # nullspace vector out of the thin factorisation
    _, _, vt = torch.linalg.svd(A, full_matrices=A.shape[-2] < 9)
    return project_essential(vt[..., -1, :].reshape(*A.shape[:-2], 3, 3))


def sampson_sq(E: torch.Tensor, p0h: torch.Tensor,
               p1h: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance of homogeneous points [B, K, 3] under E
    [B, ..., 3, 3] -> [B, ..., K]."""
    extra = E.dim() - 3
    shape = (p0h.shape[0],) + (1,) * extra + p0h.shape[1:]
    p0h, p1h = p0h.reshape(shape), p1h.reshape(shape)
    Ep0 = apply3(E, p0h)
    Etp1 = apply3(E.transpose(-1, -2), p1h)
    num = dot3(p1h, Ep0) ** 2
    den = (Ep0[..., 0] ** 2 + Ep0[..., 1] ** 2
           + Etp1[..., 0] ** 2 + Etp1[..., 1] ** 2)
    return num / den.clamp_min(1e-12)


def triangulate_depths(R: torch.Tensor, t: torch.Tensor, x0: torch.Tensor,
                       x1: torch.Tensor):
    """Depths (z0, z1) solving z1 x1 = z0 R x0 + t by least squares, per
    correspondence.  R [B, C, 3, 3], t [B, C, 3], x0/x1 [B, K, 3] ->
    [B, C, K] each."""
    Rx0 = apply3(R, x0[:, None])                          # [B, C, K, 3]
    x1 = x1[:, None]
    t = t[:, :, None]
    a11 = dot3(Rx0, Rx0)
    a12 = -dot3(Rx0, x1)
    a22 = dot3(x1, x1)
    b1 = -dot3(Rx0, t)
    b2 = dot3(x1, t)
    det = a11 * a22 - a12 * a12
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    return (b1 * a22 - b2 * a12) / det, (a11 * b2 - a12 * b1) / det


def decompose_and_vote(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                       w: torch.Tensor):
    """E [B, 3, 3] -> (R [B, 3, 3], t [B, 3]) by the cheirality vote
    (weights w [B, K]) over the 4 decompositions."""
    u, _, vt = torch.linalg.svd(E)
    u = u * torch.sign(det3(u))[:, None, None]          # proper rotations
    vt = vt * torch.sign(det3(vt))[:, None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device).expand_as(E)
    R1 = matmul3(matmul3(u, W), vt)
    R2 = matmul3(matmul3(u, W.transpose(-1, -2)), vt)
    tv = u[..., 2]
    cands_R = torch.stack([R1, R1, R2, R2], 1)           # [B, 4, 3, 3]
    cands_t = torch.stack([tv, -tv, tv, -tv], 1)         # [B, 4, 3]
    z0, z1 = triangulate_depths(cands_R, cands_t, x0, x1)
    votes = (((z0 > 0) & (z1 > 0)) * w[:, None]).sum(-1)
    best = torch.argmax(votes, -1)
    ar = torch.arange(E.shape[0], device=E.device)
    return cands_R[ar, best], cands_t[ar, best]


def draw_samples(valid: torch.Tensor, num_hypotheses: int, solver: str = "8pt",
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample indices [B, H, n] (with replacement) uniformly over each
    pair's valid matches; a pair without valid matches samples all slots
    (its estimate is not ``ok``).  ``generator`` lives on valid's device."""
    n = SAMPLE_SIZE[solver]
    w = valid.float()
    w = torch.where(w.sum(-1, keepdim=True) > 0, w, torch.ones_like(w))
    idx = torch.multinomial(w, num_hypotheses * n, replacement=True,
                            generator=generator)
    return idx.reshape(valid.shape[0], num_hypotheses, n)


def _take(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """p [B, K, 2] at idx [B, H, n] -> [B, H, n, 2]."""
    B, H, n = idx.shape
    return torch.gather(p, 1, idx.reshape(B, H * n, 1).expand(-1, -1, 2)
                        ).reshape(B, H, n, 2)


def ransac_from_samples(kpts0: torch.Tensor, kpts1: torch.Tensor,
                        K0: torch.Tensor, K1: torch.Tensor,
                        valid: torch.Tensor, samples: torch.Tensor,
                        pixel_thr: float = 0.5,
                        solver: str = "8pt") -> PoseEstimate:
    """Pose of every pair from given hypothesis samples.

    kpts0/kpts1: [B, K, 2] pixel coords (padded); K0/K1: [B, 3, 3];
    valid: [B, K] bool; samples: [B, H, 8] (``"8pt"``) or [B, H, 5]
    (``"5pt"``) indices into K; pixel_thr: the inlier threshold in px,
    normalized by the pair's mean focal length (metrics.py:80).
    """
    if solver not in SAMPLE_SIZE:
        raise ValueError(f"unknown solver {solver!r}")
    if samples.shape[-1] != SAMPLE_SIZE[solver]:
        raise ValueError(f"solver {solver!r} takes samples of "
                         f"{SAMPLE_SIZE[solver]}: {tuple(samples.shape)}")
    p0 = normalize(kpts0, K0)
    p1 = normalize(kpts1, K1)
    p0h, p1h = homogeneous(p0), homogeneous(p1)
    wf = valid.to(p0.dtype)
    focal = (K0[:, 0, 0] + K0[:, 1, 1] + K1[:, 0, 0] + K1[:, 1, 1]) / 4.0
    thr_sq = ((pixel_thr / focal) ** 2)[:, None]              # [B, 1]
    ok = valid.sum(-1) >= MIN_MATCHES[solver]
    samples = samples.to(device=kpts0.device, dtype=torch.long)

    def count(E):                    # inliers of E [B, ..., 3, 3]: [B, ...]
        err = sampson_sq(E, p0h, p1h)
        lead = (1,) * (err.dim() - 2)
        return ((err < thr_sq.reshape(-1, *lead, 1))
                & valid.reshape(valid.shape[0], *lead, -1)).sum(-1)

    s0, s1 = _take(p0, samples), _take(p1, samples)          # [B, H, n, 2]
    if solver == "5pt":
        from loftr_tpu_torch.eval.five_point_batched import \
            solve_5point_batched
        B, H = samples.shape[:2]
        Es, Eok = solve_5point_batched(s0.reshape(B * H, 5, 2).double(),
                                       s1.reshape(B * H, 5, 2).double())
        Es = Es.to(p0.dtype).reshape(B, -1, 3, 3)            # [B, H*10, 3, 3]
        scores = count(Es).masked_fill(~Eok.reshape(B, -1), -1)
    else:
        Es = eight_point(s0, s1, torch.ones_like(s0[..., 0]))  # [B, H, 3, 3]
        scores = count(Es)
    best = torch.argmax(scores, -1)
    ar = torch.arange(Es.shape[0], device=Es.device)
    E_best = Es[ar, best]                                    # [B, 3, 3]

    E_cur = E_fin = E_best
    n_fin = count(E_best)
    for mult in LO_SCHEDULE:
        e = sampson_sq(E_cur, p0h, p1h)
        w = wf / (1.0 + e / (thr_sq * mult))
        E_cur = eight_point(p0, p1, w)
        n_new = count(E_cur)
        better = n_new >= n_fin
        E_fin = torch.where(better[:, None, None], E_cur, E_fin)
        n_fin = torch.where(better, n_new, n_fin)
    inl_fin = (sampson_sq(E_fin, p0h, p1h) < thr_sq) & valid

    R, t = decompose_and_vote(E_fin, p0h, p1h, inl_fin.to(p0.dtype))
    return PoseEstimate(R=R, t=t, E=E_fin, inliers=inl_fin,
                        num_inliers=inl_fin.sum(-1), ok=ok, best=best)


def estimate_pose_ransac(kpts0: torch.Tensor, kpts1: torch.Tensor,
                         K0: torch.Tensor, K1: torch.Tensor,
                         valid: torch.Tensor, pixel_thr: float = 0.5,
                         num_hypotheses: int = 512, solver: str = "8pt",
                         generator: Optional[torch.Generator] = None
                         ) -> PoseEstimate:
    """:func:`ransac_from_samples` on ``num_hypotheses`` samples drawn by
    :func:`draw_samples` (``generator`` on the tensors' device)."""
    samples = draw_samples(valid, num_hypotheses, solver, generator)
    return ransac_from_samples(kpts0, kpts1, K0, K1, valid, samples,
                               pixel_thr, solver)
