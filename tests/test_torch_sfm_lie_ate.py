"""PyTorch port: the SfM backend's Lie utilities, trajectory error and pose
graph against the JAX package's (``loftr_tpu.sfm.{lie,ate,pose_graph}``),
on the same seeded numpy inputs, on the CPU.

Tolerances: the Lie functions 1e-6 absolute (float32, both small-angle
branches); the numpy copies (ate, pose_graph) equal JAX's exactly, since
they run the same numpy code.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.sfm import ate as jate
from loftr_tpu.sfm import lie as jlie
from loftr_tpu.sfm import pose_graph as jpg
from loftr_tpu_torch.sfm import ate as tate
from loftr_tpu_torch.sfm import lie as tlie
from loftr_tpu_torch.sfm import pose_graph as tpg

LIE_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _axis_angles(seed, n=16):
    """Rotation vectors spanning both small-angle switches: exact zeros,
    norms under 1e-8 and 1e-6, near 1e-6, and O(1) angles up to pi - 0.05."""
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    norms = np.array([0.0, 1e-9, 5e-8, 3e-7, 9e-7, 1.1e-6, 5e-6, 1e-4,
                      1e-2, 0.1, 0.5, 1.0, 2.0, 2.8, np.pi - 0.05, 1.7])
    return (d * norms[:n, None]).astype(np.float32)


def _j(x):
    return np.array(x)


def _t(x):
    return x.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_exp_so3_matches_jax(seed):
    w = _axis_angles(seed)
    want = _j(jlie.exp_so3(jnp.asarray(w)))
    got = _t(tlie.exp_so3(torch.from_numpy(w)))
    np.testing.assert_allclose(got, want, atol=LIE_ATOL, rtol=0)
    # and the hat operator
    np.testing.assert_array_equal(_t(tlie.hat(torch.from_numpy(w))),
                                  _j(jlie.hat(jnp.asarray(w))))


@pytest.mark.parametrize("seed", [0, 1])
def test_exp_se3_matches_jax(seed):
    rng = np.random.RandomState(100 + seed)
    xi = np.concatenate([_axis_angles(seed), rng.randn(16, 3)],
                        1).astype(np.float32)
    want = _j(jlie.exp_se3(jnp.asarray(xi)))
    got = _t(tlie.exp_se3(torch.from_numpy(xi)))
    np.testing.assert_allclose(got, want, atol=LIE_ATOL, rtol=0)


def test_log_so3_matches_jax():
    """Both branches: R = I (theta < eps, 0.5 scale) and generic rotations;
    the cosine clip at +-(1 - 1e-7) keeps theta finite at the identity."""
    w = _axis_angles(2)
    R = np.array(jlie.exp_so3(jnp.asarray(w)))
    R[0] = np.eye(3, dtype=np.float32)
    want = _j(jlie.log_so3(jnp.asarray(R)))
    got = _t(tlie.log_so3(torch.from_numpy(R)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LIE_ATOL, rtol=0)


def test_inv_se3_and_compose_match_jax():
    rng = np.random.RandomState(3)
    xi = (rng.randn(6, 6) * 0.4).astype(np.float32)
    T = _j(jlie.exp_se3(jnp.asarray(xi)))
    want = _j(jlie.inv_se3(jnp.asarray(T)))
    got = _t(tlie.inv_se3(torch.from_numpy(T)))
    np.testing.assert_allclose(got, want, atol=LIE_ATOL, rtol=0)
    np.testing.assert_allclose(
        _t(tlie.compose(torch.from_numpy(T), torch.from_numpy(got))),
        np.tile(np.eye(4, dtype=np.float32), (6, 1, 1)), atol=1e-5)


def test_ate_matches_jax():
    rng = np.random.RandomState(4)
    gt = rng.rand(12, 3) * 5
    est = 0.7 * gt @ jate.align_umeyama(gt, gt)[1] + rng.randn(12, 3) * 0.05
    for with_scale in (True, False):
        assert (tate.absolute_trajectory_error(est, gt, with_scale)
                == jate.absolute_trajectory_error(est, gt, with_scale))
    R = rng.randn(5, 3, 3)
    t = rng.randn(5, 3)
    np.testing.assert_array_equal(tate.camera_centers(R, t),
                                  jate.camera_centers(R, t))


def _rot(rng, scale):
    return _j(jlie.exp_so3(jnp.asarray(rng.randn(1, 3) * scale)))[0].astype(
        np.float64)


def test_triangulate_and_metric_scale_match_jax():
    rng = np.random.RandomState(5)
    R = _rot(rng, 0.1)
    t = np.array([0.3, -0.05, 0.02])
    X = rng.rand(40, 3) * [2, 2, 2] + [-1, -1, 3]
    Xj = X @ R.T + t
    p0 = X[:, :2] / X[:, 2:]
    p1 = Xj[:, :2] / Xj[:, 2:] + rng.randn(40, 2) * 1e-3
    want = jpg.triangulate_pair(R, t, p0, p1)
    got = tpg.triangulate_pair(R, t, p0, p1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    z_meas = got[1] * 1.7 + rng.randn(40) * 0.01
    z_meas[:3] = 0.0                                  # invalid depth pixels
    assert (tpg.metric_scale_from_depth(got[1], z_meas)
            == jpg.metric_scale_from_depth(got[1], z_meas))
    assert tpg.metric_scale_from_depth(got[1][:4], z_meas[:4]) is None


def _edges(module, seed, skip=(2,)):
    """Sequential edges 0-1, 1-2, ... (all but those in ``skip``) and
    skip-one edges, with overlapping cell ids so tracks chain."""
    rng = np.random.RandomState(seed)
    edges = []
    n = 6
    for i in range(n):
        for j in (i + 1, i + 2):
            if j >= n or (j == i + 1 and i in skip):
                continue
            m = 30
            cells_i = rng.choice(60, m, replace=False)
            cells_j = (cells_i + rng.randint(0, 3, m)) % 60
            edges.append(module.Edge(
                i, j, _rot(rng, 0.05), rng.randn(3) * 0.1,
                rng.rand(m, 2) * 600, rng.rand(m, 2) * 400, cells_i,
                cells_j))
    return edges, n


def test_chain_world_poses_with_missing_edge_matches_jax():
    edges_t, n = _edges(tpg, 6)
    edges_j, _ = _edges(jpg, 6)
    got = tpg.chain_world_poses(n, edges_t)
    want = jpg.chain_world_poses(n, edges_j)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the missing edge 2-3 carries pose 2 over unchanged
    np.testing.assert_array_equal(got[0][3], got[0][2])


@pytest.mark.parametrize("max_obs", [8, 3])
def test_build_tracks_matches_jax(max_obs):
    edges_t, _ = _edges(tpg, 7)
    edges_j, _ = _edges(jpg, 7)
    got = tpg.build_tracks(edges_t, max_obs_per_track=max_obs)
    want = jpg.build_tracks(edges_j, max_obs_per_track=max_obs)
    assert len(got) == len(want) > 0
    for tg, tw in zip(got, want):               # same tracks, same order
        assert [f for f, _ in tg] == [f for f, _ in tw]
        for (_, kg), (_, kw) in zip(tg, tw):
            np.testing.assert_array_equal(kg, kw)
        assert 2 <= len(tg) <= max_obs


def test_union_find_matches_jax():
    rng = np.random.RandomState(8)
    ut, uj = tpg._UnionFind(), jpg._UnionFind()
    for a, b in rng.randint(0, 40, (60, 2)):
        ut.union(int(a), int(b))
        uj.union(int(a), int(b))
    assert [ut.find(i) for i in range(40)] == [uj.find(i) for i in range(40)]
