"""PyTorch port: the pose solvers against the JAX package's.

- ``ransac_from_samples`` fed the samples ``jax.random.categorical`` draws
  with JAX's key, against ``loftr_tpu.eval.ransac.estimate_pose_ransac_jax``
  (B = 3, padded, about 20% outliers): the best hypothesis, the final
  inlier masks, the pose errors against ground truth, ``ok``.
- The batched 5-point solver (float64) against the host solver
  ``loftr_tpu.eval.five_point.solve_5point`` (numpy), and its recovery of
  the ground-truth E.
- The port's native loader against ``loftr_tpu.native``'s, same seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loftr_tpu.native as jax_native
from loftr_tpu.eval import ransac as jr
from loftr_tpu.eval.five_point import solve_5point
from loftr_tpu.eval.metrics import relative_pose_error
from loftr_tpu_torch import native
from loftr_tpu_torch.eval import ransac as tr
from loftr_tpu_torch.eval.five_point_batched import (constraints_jvp,
                                                     essential_constraints,
                                                     solve_5point_batched)

CAP = 256
KMAT = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def _rotation(rng, scale):
    aa = rng.randn(3) * scale
    th = np.linalg.norm(aa)
    k = aa / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _pair(seed, n, n_out, noise=0.1):
    """n matches (n_out of them random) of a random two-view geometry,
    padded to CAP.  Returns (kpts0, kpts1, valid, T_0to1)."""
    rng = np.random.RandomState(seed)
    R = _rotation(rng, 0.1)
    t = rng.randn(3)
    t /= np.linalg.norm(t)
    pts = rng.rand(n, 3) * [4, 3, 4] + [-2, -1.5, 4]
    p0 = pts @ KMAT.T
    p0 = p0[:, :2] / p0[:, 2:]
    p1 = (pts @ R.T + t) @ KMAT.T
    p1 = p1[:, :2] / p1[:, 2:]
    p0 += rng.randn(n, 2) * noise
    p1 += rng.randn(n, 2) * noise
    out = rng.choice(n, n_out, replace=False)
    p1[out] = rng.rand(n_out, 2) * [640, 480]
    k0 = np.zeros((CAP, 2), np.float32)
    k1 = np.zeros((CAP, 2), np.float32)
    k0[:n], k1[:n] = p0, p1
    valid = np.zeros(CAP, bool)
    valid[:n] = True
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return k0, k1, valid, T


def _batch():
    """B = 3: two usable pairs and one with too few matches."""
    pairs = [_pair(0, 150, 30), _pair(1, 200, 40), _pair(2, 7, 0)]
    return [np.stack(x) for x in zip(*pairs)]


def _jax_samples(key, valid, H, n):
    """The samples estimate_pose_ransac_jax draws for one pair."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return np.asarray(jax.random.categorical(
        key, logits[None, None, :], axis=-1, shape=(H, n)))


def _jax_best(k0, k1, valid, samples, thr):
    """The index of the best hypothesis inside estimate_pose_ransac_jax."""
    with jax.default_matmul_precision("highest"):
        K = jnp.asarray(KMAT)
        p0, p1 = jr._normalize(jnp.asarray(k0), K), jr._normalize(
            jnp.asarray(k1), K)
        thr_sq = (thr / 500.0) ** 2

        def score(idx):
            E = jr._eight_point(p0[idx], p1[idx], jnp.ones((8,), p0.dtype))
            return jnp.sum((jr._sampson_sq(E, p0, p1) < thr_sq)
                           & jnp.asarray(valid))

        return int(jnp.argmax(jax.vmap(score)(jnp.asarray(samples))))


@pytest.fixture(scope="module")
def eight_point_runs():
    k0, k1, valid, T = _batch()
    H, thr = 256, 1.0
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    want = [jr.estimate_pose_ransac_jax(
        jnp.asarray(k0[b]), jnp.asarray(k1[b]), jnp.asarray(KMAT),
        jnp.asarray(KMAT), jnp.asarray(valid[b]), keys[b], pixel_thr=thr,
        num_hypotheses=H) for b in range(3)]
    samples = np.stack([_jax_samples(keys[b], valid[b], H, 8)
                        for b in range(3)])
    Kb = torch.from_numpy(np.stack([KMAT] * 3))
    got = tr.ransac_from_samples(
        torch.from_numpy(k0), torch.from_numpy(k1), Kb, Kb,
        torch.from_numpy(valid), torch.from_numpy(samples), pixel_thr=thr)
    jbest = [_jax_best(k0[b], k1[b], valid[b], samples[b], thr)
             for b in range(3)]
    return k0, k1, valid, T, want, got, jbest


@pytest.mark.parametrize("b", [0, 1])
def test_ransac_best_hypothesis_equal(eight_point_runs, b):
    *_, got, jbest = eight_point_runs
    assert int(got.best[b]) == jbest[b]


@pytest.mark.parametrize("b", [0, 1])
def test_ransac_inlier_masks_agree(eight_point_runs, b):
    _, _, valid, _, want, got, _ = eight_point_runs
    w = np.asarray(want[b].inliers)
    g = got.inliers[b].numpy()
    assert (w == g).mean() >= 0.995
    assert not g[~valid[b]].any()
    assert int(got.num_inliers[b]) == int(g.sum())


@pytest.mark.parametrize("b", [0, 1])
def test_ransac_pose_errors_match_jax(eight_point_runs, b):
    _, _, _, T, want, got, _ = eight_point_runs
    tw, rw = relative_pose_error(T[b], np.asarray(want[b].R),
                                 np.asarray(want[b].t))
    tg, rg = relative_pose_error(T[b], got.R[b].double().numpy(),
                                 got.t[b].double().numpy())
    assert abs(rg - rw) <= 0.05 and abs(tg - tw) <= 0.05, (rg, rw, tg, tw)
    assert rg < 1.0 and tg < 3.0


def test_ransac_ok_equal_for_too_few_matches(eight_point_runs):
    *_, want, got, _ = eight_point_runs
    assert [bool(w.ok) for w in want] == got.ok.tolist() == [True, True,
                                                             False]


@pytest.mark.parametrize("solver", ["8pt", "5pt"])
def test_estimate_pose_ransac_draws_and_recovers(solver):
    """The port's own sampling: valid slots only, seeded, and the pose."""
    k0, k1, valid, T = _batch()
    valid = valid[:2]
    g = torch.Generator().manual_seed(0)
    s = tr.draw_samples(torch.from_numpy(valid), 64, solver, g)
    assert s.shape == (2, 64, tr.SAMPLE_SIZE[solver])
    assert bool(torch.from_numpy(valid).gather(1, s.flatten(1)).all())
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(s, tr.draw_samples(torch.from_numpy(valid), 64,
                                          solver, g2))
    Kb = torch.from_numpy(np.stack([KMAT] * 2))
    est = tr.estimate_pose_ransac(
        torch.from_numpy(k0[:2]), torch.from_numpy(k1[:2]), Kb, Kb,
        torch.from_numpy(valid), pixel_thr=1.0,
        num_hypotheses=64 if solver == "5pt" else 256, solver=solver,
        generator=torch.Generator().manual_seed(1))
    for b in range(2):
        t_err, r_err = relative_pose_error(T[b], est.R[b].double().numpy(),
                                           est.t[b].double().numpy())
        assert r_err < 1.0 and t_err < 3.0, (solver, b, r_err, t_err)


def _minimal_sample(seed):
    rng = np.random.RandomState(seed)
    R = _rotation(rng, 0.2)
    t = rng.randn(3)
    t /= np.linalg.norm(t)
    pts = rng.rand(5, 3) * [4, 3, 4] + [-2, -1.5, 4]
    q = pts @ R.T + t
    Tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = Tx @ R
    return pts[:, :2] / pts[:, 2:], q[:, :2] / q[:, 2:], E / np.linalg.norm(E)


def _dist(a, b):
    """Distance of two unit-norm E up to sign."""
    return min(np.linalg.norm(a - b), np.linalg.norm(a + b))


@pytest.fixture(scope="module")
def five_point_batch():
    seeds = list(range(32))
    p0, p1, E_gt = zip(*[_minimal_sample(s) for s in seeds])
    E, ok = solve_5point_batched(torch.tensor(np.array(p0)),
                                 torch.tensor(np.array(p1)))
    return p0, p1, E_gt, E.numpy(), ok.numpy()


@pytest.mark.parametrize("seed", range(5))
def test_five_point_roots_match_host_solver(five_point_batch, seed):
    """The same roots as solve_5point, up to scale and order.  The host
    solver's roots come from an interpolated polynomial without a polish
    and carry essential-constraint residuals of 1e-7 to 2e-4 on 5 of
    this generator's 32 seeds (9, 10, 12, 23, 29: up to 4e-4 from the
    batched roots, whose residuals are 1e-16), so this 1e-6 comparison
    runs at seeds 0-4, and test_five_point_roots_are_exact holds every
    root of all 32 seeds."""
    p0, p1, _, E, ok = five_point_batch
    ref = solve_5point(p0[seed], p1[seed])
    got = E[seed][ok[seed]]
    assert len(got) == len(ref)
    for r in ref:
        assert min(_dist(r, g) for g in got) < 1e-6


def test_five_point_roots_are_exact(five_point_batch):
    """Every root satisfies the 5 epipolar and the 10 essential constraints
    to float64 rounding, has unit norm, and the ground-truth E is among
    each sample's roots; root counts equal the host solver's."""
    p0, p1, E_gt, E, ok = five_point_batch
    for i in range(len(p0)):
        got = E[i][ok[i]]
        assert len(got) == len(solve_5point(p0[i], p1[i]))
        x0 = np.c_[p0[i], np.ones(5)]
        x1 = np.c_[p1[i], np.ones(5)]
        epi = np.einsum("ni,rij,nj->rn", x1, got, x0)
        assert np.abs(epi).max() < 1e-12
        cons = essential_constraints(torch.from_numpy(got)).abs().max()
        assert float(cons) < 1e-12
        np.testing.assert_allclose(np.linalg.norm(got, axis=(1, 2)), 1.0,
                                   atol=1e-12)
        assert min(_dist(E_gt[i], g) for g in got) < 1e-8


def test_native_matches_jax_binding(monkeypatch):
    """The port's loader builds the library (to a temporary name, then a
    rename); the JAX package's binding, pointed at that library so that
    no second build runs, gives the same answer for the same seed."""
    k0, k1, valid, _ = _pair(3, 180, 36, noise=0.3)
    k0, k1 = k0[:180], k1[:180]
    got = native.estimate_pose_native(k0, k1, KMAT, KMAT, 1.0, 512, seed=5)
    monkeypatch.setattr(jax_native, "_LIB_PATH", native._build())
    monkeypatch.setattr(jax_native, "_lib", None)
    want = jax_native.estimate_pose_native(k0, k1, KMAT, KMAT, 1.0, 512,
                                           seed=5)
    assert got is not None and want is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert native.estimate_pose_native(k0[:7], k1[:7], KMAT, KMAT) is None
    with pytest.raises(ValueError):
        native.estimate_pose_native(k0, k1[:50], KMAT, KMAT)


def test_constraints_jvp_matches_autograd():
    """The analytic derivative of the 10 essential constraints (the 5-point
    solver's Gauss-Newton Jacobian and f' of its root bracketing) equals
    forward-mode autodiff."""
    g = torch.Generator().manual_seed(0)
    E = torch.randn(6, 3, 3, dtype=torch.float64, generator=g)
    D = torch.randn(6, 3, 3, dtype=torch.float64, generator=g)
    _, want = torch.func.jvp(essential_constraints, (E,), (D,))
    np.testing.assert_allclose(constraints_jvp(E, D).numpy(), want.numpy(),
                               rtol=1e-12, atol=1e-12)
