"""PyTorch port: the SfM pipeline (``loftr_tpu_torch.sfm.pipeline``) against
the JAX package's, on a synthetic RGB-D sequence with an oracle matcher
(``tests/test_sfm_pipeline.py``'s ``SynthScene``, copied), on the CPU.

Each framework gets a fresh scene of the same seed, so the oracle's pixel
noise comes out the same in both.  Where the port is held to JAX, its
RANSAC draws are JAX's: ``pipeline.draw_samples`` is replaced by the
samples ``jax.random.categorical`` draws inside ``estimate_pose_ransac_jax``
for the same ``jax.random.split`` chain (``JaxDraws``).

Tolerances: keyframes, edge pairs, inlier sets and the BA problem's arrays
equal exactly; edge R and t within 1e-4; camera centres after BA within
1e-3 of JAX's; the port's own trajectory (its own draws) meets the JAX
tests' ATE bars: scale within 0.1 and RMSE < 0.05 with depth, RMSE < 0.2
without.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.sfm import pipeline as jpipe
from loftr_tpu.sfm.ate import absolute_trajectory_error, camera_centers
from loftr_tpu.sfm.lie import exp_so3
from loftr_tpu_torch.sfm import pipeline as tpipe


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class SynthScene:
    """Camera translating + slowly rotating through a 3D point cloud
    (tests/test_sfm_pipeline.py)."""

    def __init__(self, n_frames=20, n_pts=400, seed=0, noise=0.2):
        rng = np.random.RandomState(seed)
        self.K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
        self.pts = rng.rand(n_pts, 3) * [8, 5, 4] + [-4, -2.5, 4]
        self.noise = noise
        self.rng = rng
        self.R = np.zeros((n_frames, 3, 3))
        self.t = np.zeros((n_frames, 3))
        for f in range(n_frames):
            w = np.array([0.0, 0.015 * f, 0.002 * f])
            Rf = np.asarray(exp_so3(jnp.asarray(w[None])))[0]
            center = np.array([0.12 * f, 0.02 * np.sin(f), 0.01 * f])
            self.R[f] = Rf
            self.t[f] = -Rf @ center
        self.n_frames = n_frames

    def project(self, f):
        Xc = self.pts @ self.R[f].T + self.t[f]
        uv = Xc @ self.K.T
        uv = uv[:, :2] / uv[:, 2:]
        vis = (Xc[:, 2] > 0.5) & (uv[:, 0] > 5) & (uv[:, 0] < 635) & \
              (uv[:, 1] > 5) & (uv[:, 1] < 475)
        return uv, vis, Xc[:, 2]

    def depth_map(self, f):
        uv, vis, z = self.project(f)
        depth = np.zeros((480, 640), np.float32)
        pix = np.round(uv[vis]).astype(int)
        depth[np.clip(pix[:, 1], 0, 479), np.clip(pix[:, 0], 0, 639)] = \
            z[vis]
        return depth

    def match_fn(self, a, b):
        uva, visa, _ = self.project(a)
        uvb, visb, _ = self.project(b)
        common = np.nonzero(visa & visb)[0]
        k0 = uva[common] + self.rng.randn(len(common), 2) * self.noise
        k1 = uvb[common] + self.rng.randn(len(common), 2) * self.noise
        return (k0.astype(np.float32), k1.astype(np.float32),
                common.astype(np.int64), common.astype(np.int64))


class JaxDraws:
    """Stands in for ``pipeline.draw_samples``: the samples JAX's
    ``build_edges`` draws for each RANSAC call, from its split chain."""

    def __init__(self, key):
        self.key = key

    def __call__(self, valid, num_hypotheses, solver, generator):
        assert solver == "8pt"
        self.key, sub = jax.random.split(self.key)
        logits = jnp.where(jnp.asarray(valid[0].numpy()), 0.0, -1e9)
        s = jax.random.categorical(sub, logits[None, None, :], axis=-1,
                                   shape=(num_hypotheses, 8))
        return torch.from_numpy(np.array(s)).long()[None]


def _scene(seed, n_frames, noise):
    return SynthScene(n_frames=n_frames, noise=noise, seed=seed)


def test_keyframe_selection_matches_jax():
    assert tpipe.select_keyframes(23, 4) == jpipe.select_keyframes(23, 4)
    kw = dict(min_matches=150, max_gap=10)
    got = tpipe.select_keyframes_adaptive(30, _scene(2, 30, 0.1).match_fn,
                                          **kw)
    want = jpipe.select_keyframes_adaptive(30, _scene(2, 30, 0.1).match_fn,
                                           **kw)
    assert got == want
    assert got[0] == 0 and got[-1] == 29


@pytest.fixture(scope="module")
def edges_both():
    """JAX's and the port's edges (with depth) on JAX's draws, and JAX's
    pose-graph init."""
    kfs = list(range(0, 20, 4))
    sj, st = _scene(0, 20, 0.2), _scene(0, 20, 0.2)
    depths = [sj.depth_map(k) for k in kfs]
    want = jpipe.build_edges(kfs, sj.match_fn, sj.K, depths, 2,
                             jax.random.PRNGKey(0))
    mp = pytest.MonkeyPatch()
    mp.setattr(tpipe, "draw_samples", JaxDraws(jax.random.PRNGKey(0)))
    try:
        got = tpipe.build_edges(kfs, st.match_fn, st.K, depths, 2,
                                device="cpu")
    finally:
        mp.undo()
    return kfs, sj.K, want, got


def test_build_edges_on_jax_draws_matches_jax(edges_both):
    _, _, want, got = edges_both
    assert [(e.i, e.j) for e in got] == [(e.i, e.j) for e in want]
    assert len(got) >= 4
    for g, w in zip(got, want):
        # the same inlier sets
        np.testing.assert_array_equal(g.cells_i, w.cells_i)
        np.testing.assert_array_equal(g.kpts_i, w.kpts_i)
        np.testing.assert_array_equal(g.kpts_j, w.kpts_j)
        np.testing.assert_allclose(g.R, w.R, atol=1e-4, rtol=0)
        np.testing.assert_allclose(g.t, w.t, atol=1e-4, rtol=0)


def test_build_ba_problem_matches_jax(edges_both):
    kfs, K, want_edges, _ = edges_both
    R_w, t_w = jpipe.chain_world_poses(len(kfs), want_edges)
    want = jpipe.build_ba_problem(len(kfs), want_edges, K, R_w, t_w)
    got = tpipe.build_ba_problem(len(kfs), want_edges, K, R_w, t_w,
                                 device="cpu")
    for name in ("R", "t", "points", "obs_uv", "obs_cam", "obs_w",
                 "fix_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert tpipe.build_ba_problem(len(kfs), [], K, R_w, t_w,
                                  device="cpu") is None


def _centres(out):
    return camera_centers(out["R"], out["t"])


@pytest.mark.parametrize("depth", [True, False], ids=["depth", "no_depth"])
def test_run_sfm_on_jax_draws_matches_jax(monkeypatch, depth):
    seed, n, noise = (0, 20, 0.2) if depth else (1, 16, 0.1)
    sj, st = _scene(seed, n, noise), _scene(seed, n, noise)
    depths = [sj.depth_map(f) for f in range(n)] if depth else None
    kw = dict(depths=depths, keyframe_stride=4, link_range=2, ba_iters=15)
    want = jpipe.run_sfm(n, sj.match_fn, sj.K,
                         rng=jax.random.PRNGKey(seed), **kw)
    monkeypatch.setattr(tpipe, "draw_samples",
                        JaxDraws(jax.random.PRNGKey(seed)))
    got = tpipe.run_sfm(n, st.match_fn, st.K, device="cpu", **kw)
    assert got["keyframes"] == want["keyframes"]
    assert len(got["edges"]) == len(want["edges"])
    np.testing.assert_allclose(_centres(got), _centres(want), atol=1e-3,
                               rtol=0)
    assert abs(got["ba_cost"] - want["ba_cost"]) <= 1e-3 * want["ba_cost"]


@pytest.mark.parametrize("depth", [True, False], ids=["depth", "no_depth"])
def test_run_sfm_recovers_trajectory(depth):
    """The port with its own draws, at the JAX tests' bars."""
    seed, n, noise = (0, 20, 0.2) if depth else (1, 16, 0.1)
    scene = _scene(seed, n, noise)
    depths = [scene.depth_map(f) for f in range(n)] if depth else None
    out = tpipe.run_sfm(n, scene.match_fn, scene.K, depths=depths,
                        keyframe_stride=4, link_range=2, ba_iters=15,
                        seed=seed, device="cpu")
    kfs = out["keyframes"]
    assert len(out["edges"]) >= len(kfs) - 1
    assert out["ba_cost"] is not None
    ate = absolute_trajectory_error(
        _centres(out), camera_centers(scene.R[kfs], scene.t[kfs]))
    if depth:
        assert abs(ate["scale"] - 1.0) < 0.1, ate
        assert ate["ate_rmse"] < 0.05, ate
    else:
        assert ate["ate_rmse"] < 0.2, ate
