"""PyTorch port: Sinkhorn OT (ops/sinkhorn.py, ops/matching.py::sinkhorn_conf)
and the Sinkhorn kernel module's plain version against the JAX package.

Seeded numpy inputs go through both packages.  The JAX Pallas kernel runs in
interpret mode; on the CPU the port's ``fused_sinkhorn_match`` is its plain
version.  Bars: the XLA functions to atol 1e-5 / rtol 1e-4 (float32 sums in
another order); the kernel module at the bars of tests/test_pallas_match.py
(values rtol 1e-4 atol 1e-6, ``best_j`` and the prefilter flags exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.ops.matching import (pallas_sinkhorn_candidates,
                                    sinkhorn_conf as jax_sinkhorn_conf)
from loftr_tpu.ops.pallas.sinkhorn import fused_sinkhorn_match as jax_fused
from loftr_tpu.ops.sinkhorn import log_optimal_transport as jax_lot
from loftr_tpu_torch.ops.kernels.sinkhorn import (fused_sinkhorn_match,
                                                  sinkhorn_plain)
from loftr_tpu_torch.ops.matching import (kernel_sinkhorn_candidates,
                                          mutual_nearest_candidates,
                                          sinkhorn_conf)
from loftr_tpu_torch.ops.sinkhorn import log_optimal_transport


def _feats(B, L, S, C, seed=0, plant=8):
    """Unit features times 4 with ``plant`` exact correspondences a pair
    (tests/test_pallas_match.py::_feats)."""
    rng = np.random.RandomState(seed)
    f0 = rng.randn(B, L, C).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=-1, keepdims=True)
    f1 = rng.randn(B, S, C).astype(np.float32)
    f1 /= np.linalg.norm(f1, axis=-1, keepdims=True)
    for b in range(B):
        ii = rng.permutation(L)[:plant]
        jj = rng.permutation(S)[:plant]
        f1[b, jj] = f0[b, ii]
    return f0 * 4, f1 * 4


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("shape,iters,bin_score", [
    ((2, 12, 9), 3, 1.0), ((1, 30, 41), 5, -0.5), ((1, 7, 7), 0, 2.0)])
def test_log_optimal_transport_matches_jax(shape, iters, bin_score):
    rng = np.random.RandomState(0)
    scores = (rng.randn(*shape) * 2).astype(np.float32)
    want = np.asarray(jax_lot(jnp.asarray(scores), jnp.asarray(bin_score),
                              iters))
    got = log_optimal_transport(torch.from_numpy(scores),
                                torch.tensor(bin_score), iters).numpy()
    assert got.shape == (shape[0], shape[1] + 1, shape[2] + 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _masks(B, L, S, seed):
    rng = np.random.RandomState(seed)
    m0, m1 = rng.rand(B, L) > 0.2, rng.rand(B, S) > 0.2
    m0[0, :3] = False            # some leading cells masked
    return m0, m1


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("prefilter,bin_score", [(False, 1.0), (True, 1.5)])
def test_sinkhorn_conf_matches_jax(masked, prefilter, bin_score):
    B, L, S = 2, 48, 40
    f0, f1 = _feats(B, L, S, 32, seed=3)
    m0, m1 = _masks(B, L, S, 4) if masked else (None, None)
    wc, wa = jax_sinkhorn_conf(jnp.asarray(f0), jnp.asarray(f1),
                               jnp.asarray(bin_score), 3, _j(m0), _j(m1),
                               prefilter=prefilter)
    gc, ga = sinkhorn_conf(torch.from_numpy(f0), torch.from_numpy(f1),
                           torch.tensor(bin_score), 3, _t(m0), _t(m1),
                           prefilter=prefilter)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-4,
                               atol=1e-5)
    if prefilter:                 # the filter fired, on the same cells
        assert (np.asarray(wc) == 0).any()
        np.testing.assert_array_equal(gc.numpy() == 0, np.asarray(wc) == 0)


def test_sinkhorn_conf_gradients_match_jax():
    """d/d(features, bin_score) of a weighted sum of conf: rtol 1e-3, atol
    1e-3 of the tensor's largest entry (the bar of the training tests)."""
    B, L, S = 1, 24, 20
    f0, f1 = _feats(B, L, S, 16, seed=5)
    w = np.random.RandomState(6).rand(B, L, S).astype(np.float32)

    def jloss(a, b, bs):
        conf, assign = jax_sinkhorn_conf(a, b, bs, 3)
        return jnp.sum(conf * w) + jnp.sum(jnp.log(assign[:, -1, :]))
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(1.0))
    a = torch.from_numpy(f0).requires_grad_(True)
    b = torch.from_numpy(f1).requires_grad_(True)
    bs = torch.tensor(1.0, requires_grad=True)
    conf, assign = sinkhorn_conf(a, b, bs, 3)
    loss = (conf * torch.from_numpy(w)).sum() + assign[:, -1, :].log().sum()
    got = torch.autograd.grad(loss, (a, b, bs))
    for g, wv in zip(got, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(wv).max()))
    assert abs(float(got[2])) > 0


def _jax_kernel(f0, f1, bin_score, iters, m0=None, m1=None, prefilter=False,
                **kw):
    out = jax_fused(jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(bin_score),
                    iters, _j(m0), _j(m1), interpret=True,
                    prefilter=prefilter, **kw)
    return [np.asarray(x) for x in out]


def _port_kernel(f0, f1, bin_score, iters, m0=None, m1=None,
                 prefilter=False):
    out = fused_sinkhorn_match(
        torch.from_numpy(f0[None]), torch.from_numpy(f1[None]),
        torch.tensor(bin_score), iters,
        None if m0 is None else torch.from_numpy(m0[None]),
        None if m1 is None else torch.from_numpy(m1[None]),
        prefilter=prefilter)
    return [x[0].numpy() for x in out]


def _assert_kernel_equal(got, want):
    bv, bj, cc, pf0, pf1 = got
    wbv, wbj, wcc, wpf0, wpf1 = want
    np.testing.assert_allclose(bv, wbv, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(cc, wcc, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(bj, wbj)
    np.testing.assert_array_equal(pf0, wpf0)
    np.testing.assert_array_equal(pf1, wpf1)
    assert bj.dtype == np.int32 and pf0.dtype == bool


@pytest.mark.parametrize("L,S,C,seed,bin_score,kw", [
    (48, 48, 32, 7, 1.0, {}), (40, 56, 32, 7, 1.0, {}),
    (320, 192, 32, 9, 0.5, {"tile_l": 128})])
def test_plain_matches_pallas_kernel(L, S, C, seed, bin_score, kw):
    f0, f1 = _feats(1, L, S, C, seed=seed, plant=24 if L > 100 else 8)
    want = _jax_kernel(f0[0], f1[0], bin_score, 3, **kw)
    got = _port_kernel(f0[0], f1[0], bin_score, 3)
    _assert_kernel_equal(got, want)
    # and both equal the oracle's row best (test_pallas_match.py:104-113)
    conf, assign = jax_sinkhorn_conf(jnp.asarray(f0), jnp.asarray(f1),
                                     jnp.asarray(bin_score), 3)
    conf, assign = np.asarray(conf)[0], np.asarray(assign)[0]
    np.testing.assert_allclose(got[0], conf.max(axis=1), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got[1], conf.argmax(axis=1))
    np.testing.assert_array_equal(got[3], assign.argmax(axis=1)[:L] == S)
    np.testing.assert_array_equal(got[4], assign.argmax(axis=0)[:S] == L)


def test_plain_matches_pallas_kernel_masked():
    """Masked 64x64 (test_pallas_match.py:116): a fully masked row or
    column carries conf 0 and argmax 0 in the Pallas kernel, the oracle and
    the port alike (the dustbin absorbs its mass, so the TPU padding
    columns change nothing)."""
    L = S = 64
    f0, f1 = _feats(1, L, S, 16, seed=8)
    m0 = np.ones(L, bool); m0[50:] = False
    m1 = np.ones(S, bool); m1[56:] = False
    want = _jax_kernel(f0[0], f1[0], 1.0, 3, m0, m1)
    got = _port_kernel(f0[0], f1[0], 1.0, 3, m0, m1)
    _assert_kernel_equal(got, want)
    conf, _ = jax_sinkhorn_conf(jnp.asarray(f0), jnp.asarray(f1),
                                jnp.asarray(1.0), 3, jnp.asarray(m0[None]),
                                jnp.asarray(m1[None]))
    conf = np.asarray(conf)[0]
    np.testing.assert_allclose(got[0], conf.max(axis=1), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[2], conf.max(axis=0), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got[1], conf.argmax(axis=1))
    assert (got[0][50:] == 0).all() and (got[1][50:] == 0).all()


@pytest.mark.parametrize("bin_score,seed,scale", [
    (1.5, 11, 1.0), (0.5, 12, 1.0), (1.3, 15, 4.0)])
def test_plain_prefilter_matches_pallas_kernel(bin_score, seed, scale):
    """prefilter=True (test_pallas_match.py:145-168): best values over the
    coupling with dustbin-dominated rows and columns zeroed; argmax where
    the row survives, and 0 (first of equal zeros) where it does not."""
    L, S = 56, 48
    f0, f1 = _feats(1, L, S, 32, seed=seed)
    f0, f1 = f0 * scale, f1 * scale
    want = _jax_kernel(f0[0], f1[0], bin_score, 3, prefilter=True)
    got = _port_kernel(f0[0], f1[0], bin_score, 3, prefilter=True)
    _assert_kernel_equal(got, want)
    conf, _ = jax_sinkhorn_conf(jnp.asarray(f0), jnp.asarray(f1),
                                jnp.asarray(bin_score), 3, prefilter=True)
    conf = np.asarray(conf)[0]
    alive = conf.max(axis=1) > 0
    if bin_score > 1.0:
        assert got[3].any() or got[4].any()     # the filter fires
        assert not alive.all()
    if scale > 1.0:     # strong matches: some rows survive, some do not
        assert alive.any() and got[3].any() and not got[3].all()
    np.testing.assert_allclose(got[0], conf.max(axis=1), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got[1][alive], conf.argmax(axis=1)[alive])
    assert (got[1][~alive] == 0).all()


def test_plain_is_batched():
    """B=2 with different masks per pair equals two B=1 calls."""
    f0, f1 = _feats(2, 40, 36, 16, seed=13)
    m0, m1 = _masks(2, 40, 36, 14)
    both = sinkhorn_plain(torch.from_numpy(f0), torch.from_numpy(f1),
                          torch.tensor(1.2), 3, torch.from_numpy(m0),
                          torch.from_numpy(m1), prefilter=True)
    for b in range(2):
        one = _port_kernel(f0[b], f1[b], 1.2, 3, m0[b], m1[b], prefilter=True)
        for x, y in zip(both, one):
            np.testing.assert_array_equal(x[b].numpy(), y)


@pytest.mark.parametrize("masked,prefilter", [(False, False), (True, True)])
def test_kernel_candidates_match_jax_and_plain_path(masked, prefilter):
    """kernel_sinkhorn_candidates == the JAX package's
    pallas_sinkhorn_candidates, and == sinkhorn_conf +
    mutual_nearest_candidates on the port's side."""
    h0, w0, h1, w1 = 6, 8, 8, 6
    L, S = h0 * w0, h1 * w1
    f0, f1 = _feats(2, L, S, 32, seed=15)
    f0, f1 = f0 * 4, f1 * 4       # strong matches survive the dustbin
    pm0 = pm1 = None
    if masked:
        pm0 = np.zeros((2, h0, w0), bool); pm0[:, :5, :7] = True
        pm1 = np.zeros((2, h1, w1), bool); pm1[:, :7, :5] = True
    bs = 1.3
    want = pallas_sinkhorn_candidates(
        jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(bs), 3, 0.1, 1,
        (h0, w0), (h1, w1), _j(pm0), _j(pm1), interpret=True,
        prefilter=prefilter)
    tf0, tf1 = torch.from_numpy(f0), torch.from_numpy(f1)
    got = kernel_sinkhorn_candidates(tf0, tf1, torch.tensor(bs), 3, 0.1, 1,
                                     (h0, w0), (h1, w1), _t(pm0), _t(pm1),
                                     prefilter=prefilter)
    v = np.asarray(want.valid)
    assert v.any()
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.j_ids.numpy()[v],
                                  np.asarray(want.j_ids)[v])
    np.testing.assert_allclose(got.mconf.numpy(), np.asarray(want.mconf),
                               rtol=1e-4, atol=1e-6)
    conf, _ = sinkhorn_conf(
        tf0, tf1, torch.tensor(bs), 3,
        None if pm0 is None else _t(pm0).reshape(2, L),
        None if pm1 is None else _t(pm1).reshape(2, S), prefilter=prefilter)
    plain = mutual_nearest_candidates(conf, 0.1, 1, (h0, w0), (h1, w1),
                                      _t(pm0), _t(pm1))
    np.testing.assert_array_equal(plain.valid.numpy(), v)
    np.testing.assert_array_equal(plain.j_ids.numpy()[v],
                                  got.j_ids.numpy()[v])
