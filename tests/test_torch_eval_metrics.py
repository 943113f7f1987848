"""PyTorch port: evaluation metrics and config-file loaders against the JAX
package's.

essential_from_pose and symmetric_epipolar_distance (on tensors) hold to
rtol 1e-5 of JAX's where the epipolar residual is well conditioned, and,
with matches placed at the 5e-4 and 1e-4 precision thresholds, within
float32's rounding bound of float64, as JAX's do; the host aggregation
(relative_pose_error, error_auc, epidist_prec, aggregate_metrics) is equal;
the config loaders give equal configs for the same files.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import loftr_tpu.config as jcfg
from loftr_tpu.eval import metrics as jm
import loftr_tpu_torch.config as tcfg
from loftr_tpu_torch.eval import metrics as tm


def _poses(rng, B):
    T = np.tile(np.eye(4), (B, 1, 1))
    for b in range(B):
        aa = rng.randn(3) * 0.3
        th = np.linalg.norm(aa)
        k = aa / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                       [-k[1], k[0], 0]])
        T[b, :3, :3] = (np.eye(3) + np.sin(th) * Kx
                        + (1 - np.cos(th)) * Kx @ Kx)
        T[b, :3, 3] = rng.randn(3)
    return T.astype(np.float32)


def _intrinsics(B):
    K = np.tile(np.array([[600.0, 0, 320], [0, 580.0, 240], [0, 0, 1]]),
                (B, 1, 1))
    K[B - 1, 0, 0], K[B - 1, 0, 2] = 700.0, 300.0
    return K.astype(np.float32)


def _at_threshold(T, K0, K1, pts0, d_target, rng):
    """pts1 whose squared symmetric epipolar distance (float64) is
    d_target: each point moved off its epipolar line."""
    E = np.einsum("bij,bjk->bik", np.stack([
        np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        for t in T[:, :3, 3].astype(np.float64)]), T[:, :3, :3])
    B, M, _ = pts0.shape
    n0 = (pts0 - K0[:, None, :2, 2]) / K0[:, None, [0, 1], [0, 1]]
    x0 = np.concatenate([n0, np.ones((B, M, 1))], -1)
    line = np.einsum("bij,bmj->bmi", E, x0)                 # in image 1
    # a point on the line, then a normal offset s: the distance is
    # quadratic in s, so rescale s until it reaches d_target (float64)
    n2 = (line[..., :2] ** 2).sum(-1, keepdims=True)
    base = -line[..., 2:] * line[..., :2] / n2
    normal = line[..., :2] / np.linalg.norm(line[..., :2], axis=-1,
                                            keepdims=True)
    base = base + 0.1 * rng.randn(B, M, 1) * np.stack(
        [-normal[..., 1], normal[..., 0]], -1)

    def dist(s):
        n1 = base + s[..., None] * normal
        x1 = np.concatenate([n1, np.ones((B, M, 1))], -1)
        Ex0 = line
        Etx1 = np.einsum("bji,bmj->bmi", E, x1)
        num = (x1 * Ex0).sum(-1) ** 2
        return num * (1 / (Ex0[..., :2] ** 2).sum(-1)
                      + 1 / (Etx1[..., :2] ** 2).sum(-1))

    s = np.full((B, M), 1e-2)
    for _ in range(60):
        s = s * np.sqrt(d_target / np.maximum(dist(s), 1e-300))
    n1 = base + s[..., None] * normal
    return (n1 * K1[:, None, [0, 1], [0, 1]] + K1[:, None, :2, 2]).astype(
        np.float32)


def _sed_f64(pts0, pts1, E, K0, K1):
    """The squared symmetric epipolar distance in float64 numpy, apart
    from both implementations under test.  [B, M]."""
    pts0, pts1, E, K0, K1 = (np.asarray(a, np.float64)
                             for a in (pts0, pts1, E, K0, K1))
    n0 = (pts0 - K0[:, None, :2, 2]) / K0[:, None, [0, 1], [0, 1]]
    n1 = (pts1 - K1[:, None, :2, 2]) / K1[:, None, [0, 1], [0, 1]]
    x0 = np.concatenate([n0, np.ones(n0.shape[:2] + (1,))], -1)
    x1 = np.concatenate([n1, np.ones(n1.shape[:2] + (1,))], -1)
    Ex0 = np.einsum("bij,bmj->bmi", E, x0)
    Etx1 = np.einsum("bji,bmj->bmi", E, x1)
    num = np.einsum("bmi,bmi->bm", x1, Ex0) ** 2
    return num * (1 / (Ex0[..., :2] ** 2).sum(-1)
                  + 1 / (Etx1[..., :2] ** 2).sum(-1))


def _condition(pts0, pts1, E, K0, K1):
    """Condition of p1^T E p0 (float64): the sum of its nine terms'
    magnitudes over the magnitude of their sum.  [B, M]."""
    n0 = (pts0 - K0[:, None, :2, 2]) / K0[:, None, [0, 1], [0, 1]]
    n1 = (pts1 - K1[:, None, :2, 2]) / K1[:, None, [0, 1], [0, 1]]
    x0 = np.concatenate([n0, np.ones(n0.shape[:2] + (1,))], -1)
    x1 = np.concatenate([n1, np.ones(n1.shape[:2] + (1,))], -1)
    terms = np.einsum("bmi,bij,bmj->bmij", x1.astype(np.float64),
                      E.astype(np.float64), x0.astype(np.float64))
    return np.abs(terms).sum((-1, -2)) / np.abs(terms.sum((-1, -2)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thr", [5e-4, 1e-4])
def test_epipolar_distance_matches_jax(thr, seed):
    """rtol 1e-5 against JAX where p1^T E p0 is well conditioned; within
    float32's rounding bound of a float64 evaluation everywhere.

    Half the matches are placed at the threshold, where p1^T E p0's nine
    terms cancel to sqrt(thr / 2) of their size: condition 40-160.  Two
    float32 evaluations that round in another order (XLA's CPU dot fuses
    its products into FMA chains in an order the port follows for E p0 but
    not for E^T p1) then differ by up to ~6e-4 relative, and each lies
    within 2.8 condition x eps32 of float64 (16 seeds, port and JAX
    alike).  So the bar there is 4 condition x eps32 from a float64
    evaluation in numpy, for the port and, as a check of the bar, for JAX,
    and 8 condition x eps32 between the port and JAX."""
    rng = np.random.RandomState(seed)
    B, M = 2, 300
    T = _poses(rng, B)
    K0, K1 = _intrinsics(B), _intrinsics(B)[::-1].copy()
    pts0 = (rng.rand(B, M, 2) * [640, 480]).astype(np.float32)
    pts1 = np.concatenate([
        _at_threshold(T, K0, K1, pts0[:, :M // 2], thr, rng),
        (rng.rand(B, M - M // 2, 2) * [640, 480]).astype(np.float32)], 1)
    E_t = tm.essential_from_pose(torch.from_numpy(T))
    E_j = jm.essential_from_pose(jnp.asarray(T))
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), rtol=1e-5,
                               atol=1e-7)
    args = [pts0, pts1, E_t.numpy(), K0, K1]
    got = tm.symmetric_epipolar_distance(
        *[torch.from_numpy(a) for a in args]).numpy()
    f64 = _sed_f64(*args)
    want = np.asarray(jm.symmetric_epipolar_distance(
        *[jnp.asarray(a) for a in args]))
    assert got.shape == want.shape == (B, M) and got.dtype == np.float32
    kappa = _condition(*args)
    h = M // 2
    # the planted matches sit at the threshold, badly conditioned
    assert np.abs(f64[:, :h] / thr - 1).max() < 1e-3
    assert np.median(kappa[:, :h]) > 30
    good = kappa <= 10
    assert good.mean() > 0.3
    np.testing.assert_allclose(got[good], want[good], rtol=1e-5)
    eps = np.finfo(np.float32).eps
    assert (np.abs(got / f64 - 1) <= 4 * kappa * eps).all()
    assert (np.abs(want / f64 - 1) <= 4 * kappa * eps).all()
    # the port against JAX directly: the sum of the two bounds
    assert (np.abs(got / want - 1) <= 8 * kappa * eps).all()


def test_epipolar_distance_zero_for_true_matches():
    rng = np.random.RandomState(1)
    T = _poses(rng, 1)
    K = _intrinsics(1)
    X = rng.rand(50, 3) * [2, 2, 2] + [-1, -1, 4]
    x1 = X @ T[0, :3, :3].T + T[0, :3, 3]
    f, c = K[0, [0, 1], [0, 1]], K[0, :2, 2]
    p0 = X[:, :2] / X[:, 2:] * f + c
    p1 = x1[:, :2] / x1[:, 2:] * f + c
    d = tm.symmetric_epipolar_distance(
        torch.tensor(p0[None]), torch.tensor(p1[None]),
        tm.essential_from_pose(torch.tensor(T.astype(np.float64))),
        torch.tensor(K.astype(np.float64)), torch.tensor(K.astype(np.float64)))
    assert float(d.max()) < 1e-20


def test_relative_pose_error_equal():
    rng = np.random.RandomState(2)
    T = _poses(rng, 4).astype(np.float64)
    for b in range(3):
        R, t = T[b + 1, :3, :3], T[b + 1, :3, 3]
        assert tm.relative_pose_error(T[b], R, t) == \
            jm.relative_pose_error(T[b], R, t)
    t_err, R_err = tm.relative_pose_error(T[0], T[0, :3, :3], T[0, :3, 3])
    assert t_err == 0.0 and R_err < 0.05   # arccos at 1 of float32 input


@pytest.mark.parametrize("errors", [[], [0.5, 3.0, 7.0, 12.0, 40.0],
                                    [np.inf, 1.0, np.inf], [25.0, 30.0]])
def test_error_auc_equal(errors):
    assert tm.error_auc(errors) == jm.error_auc(errors)


def test_epidist_prec_equal():
    rng = np.random.RandomState(3)
    per_pair = [rng.rand(n) * 1e-3 for n in (0, 10, 57)]
    assert tm.epidist_prec(per_pair, [5e-4, 1e-4]) == \
        jm.epidist_prec(per_pair, [5e-4, 1e-4])


def test_aggregate_metrics_equal():
    rng = np.random.RandomState(4)
    metrics = {"identifiers": ["a#0", "a#1", "b#0", "a#1"],
               "R_errs": [1.0, 4.0, np.inf, 4.0],
               "t_errs": [2.0, 15.0, np.inf, 15.0],
               "epi_errs": [rng.rand(n) * 1e-3 for n in (5, 0, 9, 0)]}
    for thr in (5e-4, 1e-4):
        assert tm.aggregate_metrics(metrics, thr) == \
            jm.aggregate_metrics(metrics, thr)


def _asdict(cfg):
    return dataclasses.asdict(cfg)


@pytest.fixture
def config_files(tmp_path):
    a = tmp_path / "main.yaml"
    a.write_text(yaml.safe_dump({
        "preset": "outdoor_ds",
        "loftr": {"match_coarse": {"thr": 0.3, "max_matches": 512},
                  "coarse": {"nhead": 4}},
        "trainer": {"canonical_lr": 1e-3}}))
    b = tmp_path / "data.json"
    b.write_text(json.dumps({
        "dataset": {"mgdpt_img_resize": 832},
        "loftr": {"match_coarse": {"thr": 0.25}}}))
    c = tmp_path / "ot.yml"
    c.write_text(yaml.safe_dump({"preset": "indoor_ot"}))
    return str(a), str(b), str(c)


@pytest.mark.parametrize("order,preset,overrides", [
    ((0, 1), None, None),
    ((1, 0), None, {"loftr": {"dtype": "bfloat16"}}),
    ((0, 2, 1), None, None),
    ((1,), "scannet_eval", {"trainer": {"epi_err_thr": 1e-4}}),
    ((), None, None)])
def test_config_loaders_equal(config_files, order, preset, overrides):
    paths = [config_files[i] for i in order]
    for p in paths:
        assert tcfg.load_config_file(p) == jcfg.load_config_file(p)
    kw = dict(preset=preset, overrides=overrides, fallback="scannet_eval")
    got = tcfg.get_config_from_files(*paths, **kw)
    want = jcfg.get_config_from_files(*paths, **kw)
    assert _asdict(got) == _asdict(want)


def test_config_loader_rejects_bad_files(tmp_path):
    bad = tmp_path / "cfg.toml"
    bad.write_text("a = 1")
    with pytest.raises(ValueError, match="unknown config format"):
        tcfg.load_config_file(str(bad))
    lst = tmp_path / "cfg.json"
    lst.write_text("[1, 2]")
    with pytest.raises(ValueError, match="mapping"):
        tcfg.load_config_file(str(lst))
