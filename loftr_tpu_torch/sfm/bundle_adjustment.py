"""Bundle adjustment with an explicit Schur complement
(``loftr_tpu.sfm.bundle_adjustment``).

Static shapes: observations are grouped BY POINT into a [P, O] table (O =
max observations per point; zero-weight padding), so the camera-camera
Schur fill is a per-point dense O x O block outer product summed by camera
pair.  The reduced camera system S [6C, 6C] is solved densely
(``torch.linalg.solve``), or matrix-free by block-Jacobi PCG; landmark
updates back-substitute in closed form (3x3 inverses).  The
Levenberg-Marquardt loop runs on the host, one cost read an iteration.

On the card, as JAX pins its products to 'highest':
  - every product and ``torch.linalg`` call runs in float32 with TF32 off
    (``utils/precision.true_float32``), whatever the caller's flags;
  - every scatter-add is a :class:`SegmentSum`: the rows sorted by key once,
    then summed through fixed-shape tables level by level.  The order of
    each sum follows from the keys alone, so two runs give equal bits and
    the LM loop takes the same accept/reject path (``index_add_`` sums with
    atomics on CUDA; ``index_put_(accumulate=True)`` is deterministic on
    CUDA but re-sorts on every call, which doubles a PCG step, and adds with
    atomics on a CPU of several threads: ``tools/ba_sum_compare.py``);
  - the PCG loop freezes its state on the device once JAX's exit test
    holds and reads the test on the host every ``PCG_CHECK_EVERY`` steps:
    JAX's ``while_loop`` result with a tenth of the host reads.

Distribution (:func:`make_sharded_ba_iteration`, :func:`bundle_adjust_sharded`):
the points and their observations are sharded over the ranks of a mesh
axis, the cameras replicated; every partial sum by camera is formed on its
rank and all-reduced, the camera solve runs replicated, and the landmark
back-substitution stays on its rank.

Conventions: pose = world->camera (R, t); observation uv is in NORMALIZED
camera coordinates (pixels pre-multiplied by K^-1); pose increments are
left-multiplied se3 perturbations.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import torch

from loftr_tpu_torch.parallel import comm
from loftr_tpu_torch.sfm.lie import exp_se3, hat
from loftr_tpu_torch.utils.precision import true_float32

# PCG steps between two host reads of the exit test
PCG_CHECK_EVERY = 10


@dataclass
class BAProblem:
    R: torch.Tensor        # [C, 3, 3] world->cam rotations
    t: torch.Tensor        # [C, 3]
    points: torch.Tensor   # [P, 3]
    obs_uv: torch.Tensor   # [P, O, 2] normalized coords
    obs_cam: torch.Tensor  # [P, O] int64 camera index (0 for padding)
    obs_w: torch.Tensor    # [P, O] weight, 0 for padding
    fix_mask: torch.Tensor  # [C] bool: gauge-fixed cameras (no update)

    @property
    def n_cams(self) -> int:
        return self.R.shape[0]

    def replace(self, **changes) -> "BAProblem":
        return dataclasses.replace(self, **changes)


class SegmentSum:
    """Sums of rows by integer key into ``n_keys`` slots, in an order fixed
    by the keys alone.

    The rows are sorted by key once (stable).  Each level gathers runs of up
    to ``chunk`` rows of one key into a padded [runs, chunk] table (the pad
    slots are zeroed in place) and sums each run; the next level sums the
    runs of each key the same way, until every key holds one run."""

    def __init__(self, keys: torch.Tensor, n_keys: int, chunk: int = 32):
        keys = keys.reshape(-1).long()
        self.n_keys = n_keys
        self.tables = []        # (rows of the level's input, pad slots)
        order = torch.argsort(keys, stable=True)
        k = keys[order]
        src = order
        while True:
            n = k.numel()
            counts = torch.bincount(k, minlength=n_keys)
            first = torch.cumsum(counts, 0) - counts
            pos = torch.arange(n, device=k.device) - first[k]
            runs = (counts + chunk - 1) // chunk
            run_first = torch.cumsum(runs, 0) - runs
            n_runs = int(runs.sum())
            if n_runs == n:                       # every key holds one run
                break
            slot = (run_first[k] + pos // chunk) * chunk + pos % chunk
            table = torch.zeros((n_runs * chunk,), dtype=torch.long,
                                device=k.device)
            pad = torch.ones((n_runs * chunk,), dtype=torch.bool,
                             device=k.device)
            table[slot] = src
            pad[slot] = False
            self.tables.append((table.reshape(n_runs, chunk),
                                pad.reshape(n_runs, chunk, 1)))
            k = torch.repeat_interleave(
                torch.arange(n_keys, device=k.device), runs)
            src = torch.arange(n_runs, device=k.device)
        self.src = src          # row of the last level's input for each key
        self.keys = k           # its key (unique, ascending)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        """rows [N, ...] -> [n_keys, ...]."""
        x = rows.reshape(rows.shape[0], math.prod(rows.shape[1:]))
        for table, pad in self.tables:
            x = x[table].masked_fill_(pad, 0).sum(1)
        out = x.new_zeros((self.n_keys, x.shape[1]))
        out[self.keys] = x[self.src]
        return out.reshape((self.n_keys,) + rows.shape[1:])


class BAPlan:
    """The sums by camera (and, for the dense solver, by camera pair) of one
    observation table; ``bundle_adjust`` builds it once for its loop."""

    def __init__(self, obs_cam: torch.Tensor, n_cams: int,
                 pairs: bool = True):
        self.by_cam = SegmentSum(obs_cam, n_cams)
        self.by_pair = None
        if pairs:
            self.by_pair = SegmentSum(
                obs_cam[:, :, None] * n_cams + obs_cam[:, None, :],
                n_cams * n_cams)


def _project(R, t, X):
    """Xc = R X + t; returns (pred [2], Xc [3])."""
    Xc = (R @ X[..., None])[..., 0] + t
    z = torch.clamp(Xc[..., 2:3], min=1e-6)
    return Xc[..., :2] / z, Xc


def _reprojection_cost(prob: BAProblem, huber_delta: float = 0.0,
                       kernel: str = "huber") -> torch.Tensor:
    R = prob.R[prob.obs_cam]          # [P, O, 3, 3]
    t = prob.t[prob.obs_cam]          # [P, O, 3]
    pred, _ = _project(R, t, prob.points[:, None, :])
    r = (pred - prob.obs_uv) * prob.obs_w[..., None]
    r2 = torch.sum(r ** 2, dim=-1)    # [P, O]
    if huber_delta > 0:
        rn = torch.sqrt(torch.clamp(r2, min=1e-18))
        if kernel == "tukey":
            c2 = huber_delta ** 2
            u2 = torch.clamp(r2 / c2, 0.0, 1.0)
            return torch.sum(c2 / 6 * (1 - (1 - u2) ** 3)) * 6
        return torch.sum(torch.where(
            rn <= huber_delta, r2, 2 * huber_delta * rn - huber_delta ** 2))
    return torch.sum(r2)


def reprojection_cost(prob: BAProblem, huber_delta: float = 0.0,
                      kernel: str = "huber") -> torch.Tensor:
    """Weighted reprojection cost: squared error, or the Huber (Tukey)
    objective when huber_delta > 0 (the LM loop must optimize the same
    objective the IRLS weights linearize).  A 0-d tensor."""
    with true_float32():
        return _reprojection_cost(prob, huber_delta, kernel)


def _huber_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight sqrt(w) for the Huber kernel on squared residual r2."""
    rn = torch.sqrt(torch.clamp(r2, min=1e-18))
    return torch.sqrt(torch.where(rn <= delta, torch.ones_like(rn),
                                  delta / rn))


def _tukey_weight(r2: torch.Tensor, c: float) -> torch.Tensor:
    """IRLS weight sqrt(w) for the Tukey biweight (redescending: residuals
    beyond c are fully rejected)."""
    rn = torch.sqrt(torch.clamp(r2, min=1e-18))
    u = torch.clamp(rn / c, 0.0, 1.0)
    return 1.0 - u ** 2  # sqrt of (1-u^2)^2


def _proj_jacobian(Xc):
    """d(pred)/d(Xc) [P, O, 2, 3] at camera points Xc [P, O, 3]."""
    z = torch.clamp(Xc[..., 2], min=1e-6)
    x, y = Xc[..., 0], Xc[..., 1]
    zero = torch.zeros_like(z)
    inv_z = 1.0 / z
    return torch.stack([
        torch.stack([inv_z, zero, -x * inv_z ** 2], -1),
        torch.stack([zero, inv_z, -y * inv_z ** 2], -1),
    ], dim=-2)


def _linearize(prob: BAProblem, huber_delta: float = 0.0,
               kernel: str = "huber"):
    """Per-observation residuals + Jacobians (IRLS robust weights when
    huber_delta > 0; kernel 'huber' or 'tukey').
    Returns r [P,O,2], J_c [P,O,2,6], J_p [P,O,2,3]."""
    R = prob.R[prob.obs_cam]
    t = prob.t[prob.obs_cam]
    pred, Xc = _project(R, t, prob.points[:, None, :])
    w = prob.obs_w[..., None]
    if huber_delta > 0:
        r_plain = (pred - prob.obs_uv) * w
        r2 = torch.sum(r_plain ** 2, dim=-1, keepdim=True)
        fn = _tukey_weight if kernel == "tukey" else _huber_weight
        w = w * fn(r2, huber_delta)
    r = (pred - prob.obs_uv) * w

    P_mat = _proj_jacobian(Xc)
    # d(Xc)/d(xi) for left-perturbation exp(xi) (R, t): [-hat(Xc) | I]
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device)
    dxc_dxi = torch.cat([-hat(Xc), eye.expand(Xc.shape[:-1] + (3, 3))],
                        dim=-1)
    J_c = (P_mat @ dxc_dxi) * w[..., None]          # [P, O, 2, 6]
    J_p = (P_mat @ R) * w[..., None]                # [P, O, 2, 3]
    return r, J_c, J_p


def _damping_scale(H: torch.Tensor, n: int) -> torch.Tensor:
    """max(trace(H) / n, 1e-8) as [..., 1, 1]."""
    tr = H.diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.clamp(tr[..., None, None] / n, min=1e-8)


def _build_normal_terms(prob: BAProblem, lm_lambda, huber_delta=0.0,
                        kernel="huber", plan: Optional[BAPlan] = None):
    """All per-point/per-camera normal-equation pieces."""
    plan = plan or BAPlan(prob.obs_cam, prob.n_cams, pairs=False)
    r, J_c, J_p = _linearize(prob, huber_delta, kernel)
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)

    # camera blocks
    Hcc_blocks = torch.einsum("poia,poib->poab", J_c, J_c)   # [P, O, 6, 6]
    b_c_obs = -torch.einsum("poia,poi->poa", J_c, r)         # [P, O, 6]
    Hcc = plan.by_cam(Hcc_blocks.reshape(-1, 6, 6))
    b_c = plan.by_cam(b_c_obs.reshape(-1, 6))

    # point blocks
    Hpp = torch.einsum("poia,poib->pab", J_p, J_p)           # [P, 3, 3]
    b_p = -torch.einsum("poia,poi->pa", J_p, r)              # [P, 3]
    Hpp = Hpp + lm_lambda * eye3 * _damping_scale(Hpp, 3)
    Hpp_inv = torch.linalg.inv(Hpp + 1e-9 * eye3)

    # cross blocks per observation (unique (cam, point) per obs)
    A = torch.einsum("poia,poib->poab", J_c, J_p)            # [P, O, 6, 3]
    return r, Hcc, b_c, Hpp_inv, b_p, A


def _block_diag(S: torch.Tensor) -> torch.Tensor:
    """The [C, 6, 6] diagonal blocks of S [C, C, 6, 6], as a view."""
    return S.diagonal(dim1=0, dim2=1).permute(2, 0, 1)


def _schur_reduce(prob: BAProblem, Hcc, b_c, Hpp_inv, b_p, A, lm_lambda,
                  plan: Optional[BAPlan] = None):
    """Form the reduced camera system S, rhs."""
    plan = plan or BAPlan(prob.obs_cam, prob.n_cams)
    C = prob.n_cams
    G = torch.einsum("poab,pbc->poac", A, Hpp_inv)           # [P, O, 6, 3]

    # S -= sum_p sum_{o1,o2} G[p,o1] A[p,o2]^T at block (cam_o1, cam_o2)
    pair_blocks = torch.einsum("poac,pqbc->poqab", G, A)     # [P, O, O, 6, 6]
    # (the sum of the negated blocks, as JAX adds them: negation is exact)
    S = -plan.by_pair(pair_blocks.reshape(-1, 6, 6)).reshape(C, C, 6, 6)
    _block_diag(S).add_(Hcc)

    # rhs: b_c - sum_obs G b_p[point]
    gb = torch.einsum("poac,pc->poa", G, b_p)                # [P, O, 6]
    rhs = b_c - plan.by_cam(gb.reshape(-1, 6))

    # LM damping on camera blocks
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    _block_diag(S).add_(lm_lambda * eye6 * _damping_scale(Hcc, 6))
    return S, rhs


# ---------------------------------------------------------------------------
# Matrix-free PCG on the reduced camera system: each CG iteration applies
#     S v = (Hcc + lambda D) v - sum_obs A_po Hpp_inv_p A_po^T v[cam_po]
# with O(P*O) gathers and sums, preconditioned by the exact 6x6 diagonal
# blocks of S (exact because each point sees a camera at most once; padding
# rows have A == 0 and contribute nothing).
# ---------------------------------------------------------------------------

def _identity(x):
    return x


def _schur_matvec(plan: BAPlan, obs_cam, Hcc_damped, Hpp_inv, A, v,
                  reduce=_identity):
    """Apply the reduced camera matrix S to v [C, 6] without forming S.
    ``reduce`` sums the points' part over the ranks of a sharded problem."""
    vc = v[obs_cam]                                        # [P, O, 6]
    u = torch.einsum("poab,poa->pb", A, vc)                # [P, 3] A^T v
    w = torch.einsum("pab,pb->pa", Hpp_inv, u)             # [P, 3]
    Aw = torch.einsum("poab,pb->poa", A, w)                # [P, O, 6]
    out = reduce(-plan.by_cam(Aw.reshape(-1, 6)))
    return out + torch.einsum("cab,cb->ca", Hcc_damped, v)


def _schur_diag_blocks(plan: BAPlan, Hcc_damped, Hpp_inv, A,
                       reduce=_identity):
    """Exact 6x6 diagonal blocks of S."""
    G = torch.einsum("poab,pbc->poac", A, Hpp_inv)         # [P, O, 6, 3]
    d = torch.einsum("poac,pobc->poab", G, A)              # [P, O, 6, 6]
    return Hcc_damped - reduce(plan.by_cam(d.reshape(-1, 6, 6)))


def _vdot(a, b):
    return torch.sum(a * b)


def _pcg(matvec, Minv_blocks, rhs, active, iters: int, rtol: float):
    """Block-Jacobi preconditioned CG restricted to active cameras.

    active [C] masks out gauge-fixed cameras (their delta stays 0, matching
    _solve_cameras' identity-row treatment).  At most ``iters`` steps, with
    JAX's relative-residual exit: the state stops changing on the device
    once ``|r|^2 <= rtol^2 |b|^2``, and the loop ends at the first host read
    (every ``PCG_CHECK_EVERY`` steps) that finds it so."""
    act = active[:, None].to(rhs.dtype)
    rhs = rhs * act

    def apply_S(v):
        return matvec(v * act) * act

    def apply_M(v):
        return torch.einsum("cab,cb->ca", Minv_blocks, v) * act

    x = torch.zeros_like(rhs)
    r = rhs
    z = apply_M(r)
    p = z
    rz = _vdot(r, z)
    stop2 = (rtol ** 2) * torch.clamp(_vdot(rhs, rhs), min=1e-30)
    for k in range(iters):
        live = _vdot(r, r) > stop2
        if k % PCG_CHECK_EVERY == 0 and not bool(live):
            break
        Sp = apply_S(p)
        alpha = rz / torch.clamp(_vdot(p, Sp), min=1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Sp
        z_new = apply_M(r_new)
        rz_new = _vdot(r_new, z_new)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p_new = z_new + beta * p
        x, r, z, p, rz = (torch.where(live, a, b) for a, b in (
            (x_new, x), (r_new, r), (z_new, z), (p_new, p), (rz_new, rz)))
    return x


def _solve_cameras_pcg(prob: BAProblem, Hcc, b_c, Hpp_inv, b_p, A,
                       lm_lambda, cg_iters: int = 100, cg_rtol: float = 1e-6,
                       plan: Optional[BAPlan] = None, reduce=_identity):
    """Gauge-fixed reduced-system solve via matrix-free PCG: the damping and
    gauge of _schur_reduce + _solve_cameras with O(P*O) work a CG
    iteration and no [C,C] or [P,O,O] tensor.  On a sharded problem
    ``reduce`` sums each part over the points (the right-hand side's
    correction, the diagonal blocks, each matvec) over the ranks; ``Hcc``
    and ``b_c`` come in summed."""
    plan = plan or BAPlan(prob.obs_cam, prob.n_cams, pairs=False)
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    Hcc_damped = Hcc + lm_lambda * eye6 * _damping_scale(Hcc, 6)

    G = torch.einsum("poab,pbc->poac", A, Hpp_inv)
    gb = torch.einsum("poac,pc->poa", G, b_p)
    rhs = b_c - reduce(plan.by_cam(gb.reshape(-1, 6)))

    D = _schur_diag_blocks(plan, Hcc_damped, Hpp_inv, A, reduce)
    # fixed cameras: identity block so the inverse is well-posed
    fixed = prob.fix_mask
    D = torch.where(fixed[:, None, None], eye6[None], D + 1e-8 * eye6)
    Minv = torch.linalg.inv(D)

    matvec = partial(_schur_matvec, plan, prob.obs_cam, Hcc_damped, Hpp_inv,
                     A, reduce=reduce)
    return _pcg(matvec, Minv, rhs, ~fixed, cg_iters, cg_rtol)


def _solve_cameras(prob: BAProblem, S, rhs):
    """Dense solve of the (gauge-fixed) reduced system."""
    C = prob.n_cams
    # gauge fixing: identity rows/cols for fixed cameras
    fixed = prob.fix_mask
    blockmask = (~fixed[:, None]) & (~fixed[None, :])
    S = torch.where(blockmask[:, :, None, None], S, torch.zeros_like(S))
    eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
    diag = _block_diag(S)
    diag.copy_(torch.where(fixed[:, None, None], eye6[None], diag))
    rhs = torch.where(fixed[:, None], torch.zeros_like(rhs), rhs)

    Sd = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    delta = torch.linalg.solve(Sd, rhs.reshape(-1))
    return delta.reshape(C, 6)


def _back_substitute(prob: BAProblem, Hpp_inv, b_p, A, delta_c):
    """Landmark updates: dp = Hpp^-1 (b_p - sum_o A_o^T dc_{cam_o})."""
    dc = delta_c[prob.obs_cam]                       # [P, O, 6]
    At_dc = torch.einsum("poab,poa->pb", A, dc)
    return torch.einsum("pab,pb->pa", Hpp_inv, b_p - At_dc)


def _apply_update(prob: BAProblem, delta_c, delta_p):
    T = exp_se3(delta_c)                             # [C, 4, 4]
    R_new = T[:, :3, :3] @ prob.R
    t_new = (T[:, :3, :3] @ prob.t[..., None])[..., 0] + T[:, :3, 3]
    return prob.replace(R=R_new, t=t_new, points=prob.points + delta_p)


def ba_iteration(prob: BAProblem, lm_lambda, huber_delta: float = 0.0,
                 kernel: str = "huber", solver: str = "dense",
                 cg_iters: int = 100, plan: Optional[BAPlan] = None
                 ) -> Tuple[BAProblem, torch.Tensor, torch.Tensor]:
    """One damped Gauss-Newton (LM) step (optionally robust).

    solver: 'dense' forms the reduced camera system explicitly (O(P*O^2)
    fill, exact [6C,6C] solve); 'pcg' is matrix-free block-Jacobi PCG
    (O(P*O) per CG iteration, never materializes S - use for large C).
    ``plan``: the observation table's sums (:class:`BAPlan`), built here
    when not given.  Returns (candidate problem, old cost, new cost); the
    products run in float32 with TF32 off (see the module docstring)."""
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown BA solver {solver!r}")
    if plan is None:
        plan = BAPlan(prob.obs_cam, prob.n_cams, pairs=solver == "dense")
    with true_float32():
        r, Hcc, b_c, Hpp_inv, b_p, A = _build_normal_terms(
            prob, lm_lambda, huber_delta, kernel, plan)
        if solver == "pcg":
            delta_c = _solve_cameras_pcg(prob, Hcc, b_c, Hpp_inv, b_p, A,
                                         lm_lambda, cg_iters=cg_iters,
                                         plan=plan)
        else:
            S, rhs = _schur_reduce(prob, Hcc, b_c, Hpp_inv, b_p, A,
                                   lm_lambda, plan)
            delta_c = _solve_cameras(prob, S, rhs)
        delta_p = _back_substitute(prob, Hpp_inv, b_p, A, delta_c)
        new_prob = _apply_update(prob, delta_c, delta_p)
        return (new_prob, _reprojection_cost(prob, huber_delta, kernel),
                _reprojection_cost(new_prob, huber_delta, kernel))


def bundle_adjust(prob: BAProblem, max_iters: int = 20,
                  lm_lambda0: float = 1e-4,
                  tol: float = 1e-10, verbose: bool = False,
                  huber_delta: float = 0.0, kernel: str = "huber",
                  solver: str = "dense", cg_iters: int = 100
                  ) -> Tuple[BAProblem, float]:
    """Host-controlled LM loop; one cost read an iteration.

    huber_delta > 0 enables the robust kernel (units: normalized camera
    coords; e.g. 3px at f=500 -> 0.006); kernel 'huber' or 'tukey';
    solver 'dense' or 'pcg' (see ba_iteration)."""
    plan = BAPlan(prob.obs_cam, prob.n_cams, pairs=solver == "dense")
    lam = lm_lambda0
    cost = float(reprojection_cost(prob, huber_delta, kernel))
    for it in range(max_iters):
        cand, _, new_cost = ba_iteration(prob, lam, huber_delta, kernel,
                                         solver, cg_iters, plan)
        new_cost = float(new_cost)
        if verbose:
            print(f"BA iter {it}: cost {cost:.6e} -> {new_cost:.6e} "
                  f"(lambda={lam:.1e})")
        if new_cost < cost:
            prob = cand
            improved = cost - new_cost
            cost = new_cost
            lam = max(lam * 0.3, 1e-9)
            if improved < tol * max(cost, 1.0):
                break
        else:
            lam = min(lam * 10.0, 1e6)
            if lam >= 1e6:
                break
    return prob, cost


# ---------------------------------------------------------------------------
# Distributed BA: points (and their observations) sharded over the ranks of a
# mesh axis; the reduced camera system is formed with all-reduces and solved
# replicated; landmark back-substitution stays on its rank.
# ---------------------------------------------------------------------------

def shard_problem(prob: BAProblem, mesh, axis: str = "data") -> BAProblem:
    """This rank's contiguous slice of the points and their observations;
    the cameras stay whole (replicated).  P must split evenly."""
    from loftr_tpu_torch.parallel.mesh import shard_batch
    rows = shard_batch(mesh, {"points": prob.points, "obs_uv": prob.obs_uv,
                              "obs_cam": prob.obs_cam, "obs_w": prob.obs_w},
                       axis)
    return prob.replace(**rows)


def make_sharded_ba_iteration(mesh, axis: str = "data",
                              solver: str = "dense", cg_iters: int = 100):
    """A BA iteration over a point-sharded problem (JAX's signature).

    The returned ``step(prob, lm_lambda, plan=None)`` takes this rank's
    shard (:func:`shard_problem`: its points and observations, every
    camera) and its :class:`BAPlan` (built when not given), and returns
    (this rank's candidate shard, old cost, new cost), the costs global.
    Robust kernels do not apply, as in JAX's sharded iteration.

    solver 'dense': each rank fills its partial [C, C, 6, 6] S and rhs,
    one all-reduce of each, a replicated dense solve.  solver 'pcg':
    matrix-free, one all-reduce a CG matvec (and of the diagonal blocks
    and the right-hand side's correction), nothing quadratic in C.
    ``Hcc`` and ``b_c`` are all-reduced before the damping, which must see
    the global ``Hcc``.

    Every rank holds the same bits of the camera update: the all-reduce
    hands every rank the same sums, and the solve and the PCG's host exit
    tests then run on equal inputs.  Against the single-process
    :func:`ba_iteration` the sums by camera are regrouped (each rank's
    ``SegmentSum`` over its points, deterministic, then the ranks' partial
    sums added in the collective's order), which moves them by float32
    rounding, about 1e-7 of their size; the camera solve carries that
    times S's condition number (the monocular scale gauge leaves S at
    ~1e4), and the landmark back-substitution amplifies it further through
    its 3x3 inverses.  The costs agree to ~1e-5 relative."""
    if solver not in ("dense", "pcg"):
        raise ValueError(f"unknown BA solver {solver!r}")
    group = mesh.group(axis)
    reduce = partial(comm.reduce_sum, group=group)

    def step(prob: BAProblem, lm_lambda, plan: Optional[BAPlan] = None):
        if plan is None:
            plan = BAPlan(prob.obs_cam, prob.n_cams,
                          pairs=solver == "dense")
        with true_float32():
            r, Hcc_l, b_c_l, Hpp_inv, b_p, A = _build_normal_terms(
                prob, lm_lambda, plan=plan)
            # the damping must see the global Hcc: sum the parts first
            Hcc, b_c = reduce(torch.cat([Hcc_l.reshape(-1, 36), b_c_l],
                                        1)).split([36, 6], 1)
            Hcc = Hcc.reshape(-1, 6, 6)
            if solver == "pcg":
                delta_c = _solve_cameras_pcg(prob, Hcc, b_c, Hpp_inv, b_p,
                                             A, lm_lambda, cg_iters=cg_iters,
                                             plan=plan, reduce=reduce)
            else:
                S_l, rhs_l = _schur_reduce(prob, torch.zeros_like(Hcc),
                                           torch.zeros_like(b_c), Hpp_inv,
                                           b_p, A, 0.0, plan)
                S, rhs = reduce(S_l), reduce(rhs_l) + b_c
                eye6 = torch.eye(6, dtype=S.dtype, device=S.device)
                _block_diag(S).add_(Hcc)
                _block_diag(S).add_(lm_lambda * eye6
                                    * _damping_scale(Hcc, 6))
                delta_c = _solve_cameras(prob, S, rhs)   # replicated
            delta_p = _back_substitute(prob, Hpp_inv, b_p, A, delta_c)
            new_prob = _apply_update(prob, delta_c, delta_p)
            costs = reduce(torch.stack([torch.sum(r ** 2),
                                        _reprojection_cost(new_prob)]))
        return new_prob, costs[0], costs[1]

    return step


def bundle_adjust_sharded(prob: BAProblem, mesh, axis: str = "data",
                          max_iters: int = 20, lm_lambda0: float = 1e-4,
                          tol: float = 1e-10, solver: str = "dense",
                          cg_iters: int = 100) -> Tuple[BAProblem, float]:
    """The LM loop of :func:`bundle_adjust` over the sharded iteration.
    ``prob`` is this rank's shard (:func:`shard_problem`); returns this
    rank's solved shard and the global cost.  Every rank takes the same
    accept / reject path: the costs are all-reduced."""
    step = make_sharded_ba_iteration(mesh, axis, solver, cg_iters)
    plan = BAPlan(prob.obs_cam, prob.n_cams, pairs=solver == "dense")
    lam = lm_lambda0
    cost = None
    for _ in range(max_iters):
        cand, old_cost, new_cost = step(prob, lam, plan)
        if cost is None:
            cost = float(old_cost)
        new_cost = float(new_cost)
        if new_cost < cost:
            prob = cand
            improved = cost - new_cost
            cost = new_cost
            lam = max(lam * 0.3, 1e-9)
            if improved < tol * max(cost, 1.0):
                break
        else:
            lam = min(lam * 10.0, 1e6)
            if lam >= 1e6:
                break
    return prob, cost


# ---------------------------------------------------------------------------
# Per-point outlier-vs-reset stage (between the Huber and Tukey rounds of an
# annealed robust schedule).  The redescending Tukey kernel can permanently
# reject GOOD observations of a point that an early gross outlier dragged
# off.  The fix is point-local: gate each observation by its residual,
# retriangulate every point from its gated observations only (cameras held
# fixed - 3x3 GN solves, batched), and zero the weight of observations that
# still disagree afterwards.
# ---------------------------------------------------------------------------

def reset_point_outliers(prob: BAProblem, thr: float,
                         gn_iters: int = 8) -> BAProblem:
    """RANSAC-style per-track consensus: retriangulation + outlier removal.

    For every point, all O(O^2) two-view midpoint triangulations of its
    observation pairs are candidate positions (plus the current position);
    the candidate with maximum observation support (residual < thr; the
    first maximum) wins if it beats the current position's support strictly,
    is GN-polished on its gated inliers (cameras fixed), and observations
    still beyond the gate afterwards get their weight zeroed.  Padded
    observations (weight 0) count in no support; parallel rays
    (|det| < 1e-12) give no candidate.

    thr: gate in normalized-coordinate units (same scale as huber_delta;
    e.g. 3px at f=500 -> 0.006).  Points whose best support < 2 are left
    untouched.
    """
    with true_float32():
        return _reset_point_outliers_impl(prob, thr, gn_iters)


def _reset_point_outliers_impl(prob, thr, gn_iters):
    R = prob.R[prob.obs_cam]              # [P, O, 3, 3]
    t = prob.t[prob.obs_cam]              # [P, O, 3]
    P, O = prob.obs_cam.shape
    dt = prob.points.dtype
    dev = prob.points.device
    thr2 = thr * thr
    w_valid = prob.obs_w > 0              # [P, O]

    def residual2(points):
        """points [..., P, 3] -> squared residual [..., P, O]."""
        pred, _ = _project(R, t, points[..., None, :])
        return torch.sum((pred - prob.obs_uv) ** 2, dim=-1)

    # two-view midpoint triangulation for every observation pair:
    # rays  X = c_o + s * d_o  in world coords
    Rt = R.transpose(-1, -2)
    centers = -(Rt @ t[..., None])[..., 0]                     # [P, O, 3]
    ray = torch.cat([prob.obs_uv, torch.ones((P, O, 1), dtype=dt,
                                             device=dev)], -1)
    dirs = (Rt @ ray[..., None])[..., 0]                       # [P, O, 3]
    d1 = dirs[:, :, None, :]                                   # [P, O, O, 3]
    d2 = dirs[:, None, :, :]
    c1 = centers[:, :, None, :]
    c2 = centers[:, None, :, :]
    a11 = torch.sum(d1 * d1, -1)
    a12 = -torch.sum(d1 * d2, -1)
    a22 = torch.sum(d2 * d2, -1)
    dc = c2 - c1
    b1 = torch.sum(d1 * dc, -1)
    b2 = -torch.sum(d2 * dc, -1)
    det = a11 * a22 - a12 * a12
    degen = torch.abs(det) < 1e-12                             # parallel rays
    det = torch.where(degen, torch.ones_like(det), det)
    s1 = (b1 * a22 - b2 * a12) / det
    s2 = (a11 * b2 - a12 * b1) / det
    cand = 0.5 * ((c1 + s1[..., None] * d1) + (c2 + s2[..., None] * d2))
    ar = torch.arange(O, device=dev)
    pair_ok = (w_valid[:, :, None] & w_valid[:, None, :] & ~degen &
               (ar[:, None] < ar[None, :])[None] &
               (s1 > 0) & (s2 > 0))                            # [P, O, O]

    # support of each candidate (and of the current position)
    n_cand = O * O
    cand_flat = cand.reshape(P, n_cand, 3)
    r2_cand = residual2(cand_flat.transpose(0, 1))             # [A, P, O]
    supp = torch.sum((r2_cand < thr2) & w_valid[None], dim=-1)  # [A, P]
    supp = torch.where(pair_ok.reshape(P, n_cand).T, supp,
                       torch.zeros_like(supp))
    supp_cur = torch.sum((residual2(prob.points) < thr2) & w_valid, dim=-1)

    best = torch.argmax(supp, dim=0)                           # [P], first max
    best_supp = torch.gather(supp, 0, best[None])[0]
    # switch to the consensus candidate only if it strictly beats the
    # current position's support (ties keep the smooth BA estimate)
    switch = (best_supp >= 2) & (best_supp > supp_cur)
    X0 = torch.where(switch[:, None],
                     torch.gather(cand_flat, 1,
                                  best[:, None, None].expand(-1, 1, 3))[:, 0],
                     prob.points)

    gate = (residual2(X0) < thr2) & w_valid                    # [P, O]
    can_fix = torch.sum(gate, dim=1) >= 2
    gate_w = (gate & can_fix[:, None]).to(dt)
    eye3 = torch.eye(3, dtype=dt, device=dev)

    points = X0
    for _ in range(gn_iters):
        pred, Xc = _project(R, t, points[:, None, :])
        r = (pred - prob.obs_uv) * gate_w[..., None]           # [P, O, 2]
        J = (_proj_jacobian(Xc) @ R) * gate_w[..., None, None]
        H = torch.einsum("poia,poib->pab", J, J)
        b = -torch.einsum("poia,poi->pa", J, r)
        H = H + 1e-8 * eye3
        dp = torch.linalg.solve(H, b[..., None])[..., 0]
        points = points + torch.where(can_fix[:, None], dp,
                                      torch.zeros_like(dp))
    points = torch.where(can_fix[:, None], points, prob.points)

    # hard-zero observations that still disagree with the re-solved point
    still_out = (residual2(points) >= thr2) & can_fix[:, None]
    new_w = torch.where(still_out, torch.zeros_like(prob.obs_w), prob.obs_w)
    return prob.replace(points=points, obs_w=new_w)
