"""Batched minimal 5-point essential-matrix solver on the device, in float64
(the counterpart of ``loftr_tpu.eval.five_point_tpu``).

The hidden-variable algebra of eval/five_point.py (Nister 2004 /
Stewenius 2006), with a root finder that needs no companion-matrix
eigensolver, for a batch of samples at once:

  1. the nullspace of the 5x9 epipolar system (batched SVD) gives
     E = x B0 + y B1 + z B2 + w B3;
  2. the 10 cubic essential constraints, grouped by the (x, y) monomials,
     give a 10x10 matrix C(z, w) whose entries are homogeneous in (z, w);
     the hidden variable is projective, (z, w) = (sin t, cos t) over
     t in [-pi/2, pi/2], so every evaluation stays bounded;
  3. the sign of f(t) = det C(sin t, cos t) on a uniform grid brackets the
     real roots (at most 10);
  4. a cell where f keeps its sign but f' changes sign may hold two close
     roots around an extremum: bisection on sign f' (Jacobi's formula,
     f'/f = tr(C^-1 C')) finds the extremum, and where f there has the
     other sign the cell splits into two brackets;
  5. fixed-count bisection on each bracket, the nullspace of C(t*) (batched
     10x10 SVD) for (x, y), then a residual-guarded Gauss-Newton polish of
     (x, y, t) on the 10 constraints.

The JAX package runs this in float32 with double-float arithmetic
(``ops/compensated.py``) because the TPU has no float64; the H100 has
float64, so the port computes in it and needs no compensated arithmetic.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from loftr_tpu_torch.eval.five_point import _XY_SAMPLES, _xy_vandermonde
from loftr_tpu_torch.eval.metrics import matmul3
from loftr_tpu_torch.eval.ransac import det3, epipolar_rows

N_ROOTS = 10          # real roots of det C: at most its degree
N_EXT = 9             # extremum cells checked for a hidden pair of roots
GRID = 256            # sign grid over t
BISECT_ITERS = 55     # a grid cell (pi/255) to below float64 resolution
EXT_ITERS = 30        # bisection on sign f' to an extremum
GN_ITERS = 8          # Gauss-Newton polish steps
RES_GATE = 1e-8       # squared constraint residual of a unit-norm E
CHUNK = 1024          # samples solved at once (bounds the grid's memory)

_VINV = np.asarray(_xy_vandermonde())        # [10 monomials, 10 samples]


def essential_constraints(E: torch.Tensor) -> torch.Tensor:
    """det(E) and the 9 entries of 2 E E^T E - tr(E E^T) E: [..., 10]."""
    EEt = matmul3(E, E.transpose(-1, -2))
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    M = 2.0 * matmul3(EEt, E) - tr[..., None, None] * E
    return torch.cat([det3(E)[..., None], M.flatten(-2)], -1)


def constraints_jvp(E: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Derivative of :func:`essential_constraints` at E along D, [..., 10]:
    d det = <cof(E), D>; d(2 E E^T E - tr(E E^T) E) = 2 (D E^T E + E D^T E
    + E E^T D) - 2 <E, D> E - tr(E E^T) D."""
    r0, r1, r2 = E[..., 0, :], E[..., 1, :], E[..., 2, :]
    cof = torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                       torch.linalg.cross(r0, r1)], -2)
    ddet = (cof * D).sum((-1, -2))
    Et, Dt = E.transpose(-1, -2), D.transpose(-1, -2)
    EEt = matmul3(E, Et)
    tr = EEt[..., 0, 0] + EEt[..., 1, 1] + EEt[..., 2, 2]
    dM = (2.0 * (matmul3(matmul3(D, Et), E) + matmul3(matmul3(E, Dt), E)
                 + matmul3(EEt, D))
          - 2.0 * (E * D).sum((-1, -2))[..., None, None] * E
          - tr[..., None, None] * D)
    return torch.cat([ddet[..., None], dM.flatten(-2)], -1)


def nullspace4(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """[N, 4, 3, 3] nullspace basis of the [N, 5, 9] epipolar systems."""
    _, _, vt = torch.linalg.svd(epipolar_rows(p0, p1), full_matrices=True)
    return vt[:, 5:].reshape(-1, 4, 3, 3)


def essential_of(basis: torch.Tensor, x, y, z, w) -> torch.Tensor:
    """x B0 + y B1 + z B2 + w B3; basis [N, 4, 3, 3], coefficients [N, ...]
    -> [N, ..., 3, 3]."""
    extra = x.dim() - 1
    b = basis.reshape(basis.shape[0], *(1,) * extra, 4, 3, 3)
    c = lambda v: v[..., None, None]
    return (c(x) * b[..., 0, :, :] + c(y) * b[..., 1, :, :]
            + c(z) * b[..., 2, :, :] + c(w) * b[..., 3, :, :])


def _vandermonde_rows(evals: torch.Tensor) -> torch.Tensor:
    """[N, T, S, 10c] constraints at the (x, y) samples -> [N, T, 10c,
    10m] coefficients over the monomials."""
    vinv = torch.as_tensor(_VINV, dtype=evals.dtype, device=evals.device)
    return torch.einsum("ms,ntsc->ntcm", vinv, evals)


def _sample_essentials(basis: torch.Tensor, t: torch.Tensor):
    """E at the 10 (x, y) samples and (sin t, cos t), and dE/dt: each
    [N, T, S, 3, 3]."""
    xs = torch.as_tensor(_XY_SAMPLES[:, 0], dtype=t.dtype, device=t.device)
    ys = torch.as_tensor(_XY_SAMPLES[:, 1], dtype=t.dtype, device=t.device)
    shape = t.shape + (10,)
    z, w = torch.sin(t)[..., None].expand(shape), \
        torch.cos(t)[..., None].expand(shape)
    zero = torch.zeros(shape, dtype=t.dtype, device=t.device)
    E = essential_of(basis, xs.expand(shape), ys.expand(shape), z, w)
    return E, essential_of(basis, zero, zero, w, -z)


def c_matrix(basis: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """C(sin t, cos t): basis [N, 4, 3, 3], t [N, T] -> [N, T, 10, 10].

    Row k holds constraint k's coefficients over the (x, y) monomials
    {x^3, x^2 y, x y^2, y^3, x^2, x y, y^2, x, y, 1}, from the constraints
    at 10 generic (x, y) samples and the inverse Vandermonde matrix (the
    construction of five_point._C_of_z, whose w = 1 slice it is)."""
    return _vandermonde_rows(essential_constraints(
        _sample_essentials(basis, t)[0]))


def sign_det(basis: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.slogdet(c_matrix(basis, t))[0]


def sign_det_and_deriv(basis: torch.Tensor, t: torch.Tensor):
    """(sign f, log|f|, sign f') at t [N, T], by Jacobi's formula."""
    E, dE = _sample_essentials(basis, t)
    C = _vandermonde_rows(essential_constraints(E))
    Cp = _vandermonde_rows(constraints_jvp(E, dE))
    sign, logabs = torch.linalg.slogdet(C)
    tr = torch.linalg.solve(C, Cp).diagonal(dim1=-2, dim2=-1).sum(-1)
    return sign, logabs, sign * torch.sign(tr)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx)


def _brackets(basis: torch.Tensor):
    """Root brackets (lo, hi, sign f(lo), valid), each [N, N_ROOTS]."""
    N = basis.shape[0]
    dt, dev = basis.dtype, basis.device
    ts = torch.linspace(-math.pi / 2, math.pi / 2, GRID, dtype=dt,
                        device=dev).repeat(N, 1)
    signs, logabs, dsigns = sign_det_and_deriv(basis, ts)        # [N, G]
    flip = signs[:, :-1] * signs[:, 1:] < 0                      # [N, G-1]
    cells = torch.arange(GRID - 1, device=dev).expand(N, -1)

    # sign-change cells, in order, up to N_ROOTS
    order = torch.where(flip, cells, GRID).sort(-1).values[:, :N_ROOTS]
    pvalid = order < GRID - 1
    psafe = order.clamp_max(GRID - 2)

    # extremum cells: f' changes sign but f does not; deepest |f| first
    ext = (dsigns[:, :-1] * dsigns[:, 1:] < 0) & ~flip
    depth = torch.minimum(logabs[:, :-1], logabs[:, 1:])
    key = torch.where(ext, depth, torch.full_like(depth, math.inf))
    eorder = key.argsort(-1)[:, :N_EXT]
    evalid = torch.isfinite(_gather(key, eorder))
    elo, ehi = _gather(ts, eorder), _gather(ts, eorder + 1)
    es_lo = _gather(dsigns, eorder)
    lo, hi = elo, ehi
    for _ in range(EXT_ITERS):
        mid = 0.5 * (lo + hi)
        same = sign_det_and_deriv(basis, mid)[2] == es_lo
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    t_e = 0.5 * (lo + hi)
    s_cell = _gather(signs, eorder)
    pair = evalid & (sign_det(basis, t_e) * s_cell < 0)

    lo_all = torch.cat([_gather(ts, psafe), elo, t_e], -1)
    hi_all = torch.cat([_gather(ts, psafe + 1), t_e, ehi], -1)
    s_all = torch.cat([_gather(signs, psafe), s_cell, -s_cell], -1)
    v_all = torch.cat([pvalid, pair, pair], -1)
    take = torch.where(v_all, lo_all, torch.full_like(lo_all, math.inf)
                       ).argsort(-1)[:, :N_ROOTS]
    return (_gather(lo_all, take), _gather(hi_all, take),
            _gather(s_all, take), _gather(v_all, take))


def _solve_chunk(p0: torch.Tensor, p1: torch.Tensor):
    basis = nullspace4(p0, p1)                                    # [N,4,3,3]
    lo, hi, s_lo, valid = _brackets(basis)                        # [N, R]
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        same = sign_det(basis, mid) == s_lo
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    t = 0.5 * (lo + hi)

    # (x, y) from the nullspace of C(t*): the monomial vector [..., x, y, 1]
    m = torch.linalg.svd(c_matrix(basis, t))[2][..., -1, :]       # [N, R, 10]
    denom_ok = m[..., 9].abs() > 1e-12
    d = torch.where(denom_ok, m[..., 9], torch.ones_like(m[..., 9]))
    v = torch.stack([m[..., 7] / d, m[..., 8] / d, t], -1)        # [N, R, 3]

    def essential(v):
        return essential_of(basis, v[..., 0], v[..., 1],
                            torch.sin(v[..., 2]), torch.cos(v[..., 2]))

    def res(v):
        return essential_constraints(essential(v))

    one, zero = torch.ones_like(t), torch.zeros_like(t)
    dx = essential_of(basis, one, zero, zero, zero)               # B0
    dy = essential_of(basis, zero, one, zero, zero)               # B1
    for _ in range(GN_ITERS):
        E = essential(v)
        r = essential_constraints(E)                              # [N, R, 10]
        dt = essential_of(basis, zero, zero, torch.cos(v[..., 2]),
                          -torch.sin(v[..., 2]))
        J = torch.stack([constraints_jvp(E, D) for D in (dx, dy, dt)],
                        -1)                                       # [N,R,10,3]
        # least squares by the SVD of J (normal equations would square its
        # condition number near a close pair of roots)
        U, s, Vt = torch.linalg.svd(J, full_matrices=False)
        s_inv = torch.where(s > 1e-12 * s[..., :1], 1.0 / s,
                            torch.zeros_like(s))
        ut_r = (U * r[..., None]).sum(-2)                         # [N, R, 3]
        delta = -(Vt * (s_inv * ut_r)[..., None]).sum(-2)
        lim = 0.1 * v.abs().clamp_min(1.0)
        cand = v + torch.maximum(torch.minimum(delta, lim), -lim)
        better = (res(cand) ** 2).sum(-1) < (r ** 2).sum(-1)
        v = torch.where(better[..., None], cand, v)

    E = essential_of(basis, v[..., 0], v[..., 1], torch.sin(v[..., 2]),
                     torch.cos(v[..., 2]))                        # [N,R,3,3]
    n = E.flatten(-2).norm(dim=-1)
    norm_ok = n > 1e-12
    n = torch.where(norm_ok, n, torch.ones_like(n))
    E = E / n[..., None, None]
    # the polished unit-norm E must satisfy the cubic constraints
    resid = (res(v) ** 2).sum(-1) / n ** 6
    return E, valid & denom_ok & norm_ok & (resid < RES_GATE)


def solve_5point_batched(p0: torch.Tensor, p1: torch.Tensor):
    """All real essential matrices of each of N samples of 5 normalized
    correspondences.  p0, p1: [N, 5, 2] (computed in float64).  Returns
    (E [N, 10, 3, 3] float64 with ||E|| = 1, valid [N, 10] bool)."""
    if p0.shape != p1.shape or p0.shape[1:] != (5, 2):
        raise ValueError(f"expected two [N, 5, 2] point sets: "
                         f"{tuple(p0.shape)}, {tuple(p1.shape)}")
    p0, p1 = p0.double(), p1.double()
    outs = [_solve_chunk(p0[i:i + CHUNK], p1[i:i + CHUNK])
            for i in range(0, p0.shape[0], CHUNK)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]))
