"""PyTorch port: coarse matching and the dual-softmax kernel module's plain
version against the JAX package (the Pallas kernel in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.ops import matching as JM
from loftr_tpu.ops.pallas.dual_softmax import fused_dual_softmax_match as jfd
from loftr_tpu_torch.ops import matching as TM
from loftr_tpu_torch.ops.kernels.dual_softmax import (
    dual_softmax_plain, fused_dual_softmax_match)

C = 256  # full coarse width


def _feats(B, L, S, seed=0, plant=8):
    rng = np.random.RandomState(seed)
    f0 = rng.randn(B, L, C).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=-1, keepdims=True)
    f1 = rng.randn(B, S, C).astype(np.float32)
    f1 /= np.linalg.norm(f1, axis=-1, keepdims=True)
    for b in range(B):
        for i, j in zip(rng.permutation(L)[:plant], rng.permutation(S)[:plant]):
            f1[b, j] = f0[b, i]
    return f0 * 16, f1 * 16


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("shape,masked", [((6, 8, 6, 8), False),
                                          ((4, 5, 6, 7), False),
                                          ((8, 8, 8, 8), True)])
def test_kernel_candidates_match_jax_kernel(shape, masked):
    """valid and j_ids exact, mconf at the bar of test_pallas_match.py:43."""
    h0, w0, h1, w1 = shape
    f0, f1 = _feats(2, h0 * w0, h1 * w1, seed=1)
    pm0 = pm1 = None
    if masked:
        pm0 = np.zeros((2, h0, w0), bool)
        pm0[:, :6, :7] = True
        pm1 = pm0.copy()
    want = JM.pallas_mutual_nearest_candidates(
        jnp.asarray(f0), jnp.asarray(f1), 0.1, 0.2, 1, (h0, w0), (h1, w1),
        _j(pm0), _j(pm1), interpret=True)
    got = TM.kernel_mutual_nearest_candidates(
        _t(f0), _t(f1), 0.1, 0.2, 1, (h0, w0), (h1, w1), _t(pm0), _t(pm1))
    v = np.asarray(want.valid)
    assert v.any()
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.j_ids.numpy()[v],
                                  np.asarray(want.j_ids)[v])
    np.testing.assert_allclose(got.mconf.numpy(), np.asarray(want.mconf),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_statistics_match_jax_kernel(masked):
    """best_val / best_j / colconf of the plain version against the Pallas
    kernel over several row tiles (test_pallas_match.py:67-82 bars)."""
    L, S = 320, 200
    f0, f1 = _feats(1, L, S, seed=5, plant=20)
    r = np.random.RandomState(6)
    m0 = r.rand(L) > 0.2 if masked else None
    m1 = r.rand(S) > 0.2 if masked else None
    bv, bj, cc = jfd(jnp.asarray(f0[0]), jnp.asarray(f1[0]), 0.1, _j(m0),
                     _j(m1), tile_l=128, interpret=True)
    gv, gj, gc = fused_dual_softmax_match(
        _t(f0), _t(f1), 0.1, None if m0 is None else _t(m0[None]),
        None if m1 is None else _t(m1[None]))
    # A fully masked row (column) is -1e9 everywhere; the Pallas kernel also
    # sums its padding rows/columns there, so compare unmasked ones only
    # (masked rows never pass the row_ok test of the epilogue).
    rows = np.ones(L, bool) if m0 is None else m0
    cols = np.ones(S, bool) if m1 is None else m1
    np.testing.assert_allclose(gv[0].numpy()[rows], np.asarray(bv)[rows],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(gc[0].numpy()[cols], np.asarray(cc)[cols],
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(gj[0].numpy()[rows], np.asarray(bj)[rows])
    assert gj.dtype == torch.int32


def test_plain_argmax_takes_first_of_ties():
    f0 = np.zeros((1, 3, C), np.float32)
    f1 = np.zeros((1, 4, C), np.float32)
    _, bj, _ = dual_softmax_plain(_t(f0), _t(f1), 0.1)
    np.testing.assert_array_equal(bj.numpy(), np.zeros((1, 3)))


@pytest.mark.parametrize("masked", [False, True])
def test_plain_candidates_match_jax(masked):
    h = w = 8
    f0, f1 = _feats(1, 64, 64, seed=3)
    pm = None
    if masked:
        pm = np.zeros((1, 8, 8), bool)
        pm[:, :6, :7] = True
    mk = None if pm is None else pm.reshape(1, 64)
    conf_j = JM.dual_softmax_conf(jnp.asarray(f0), jnp.asarray(f1), 0.1,
                                  _j(mk), _j(mk))
    conf_t = TM.dual_softmax_conf(_t(f0), _t(f1), 0.1, _t(mk), _t(mk))
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j),
                               rtol=1e-4, atol=1e-7)
    want = JM.mutual_nearest_candidates(conf_j, 0.2, 1, (h, w), (h, w),
                                        _j(pm), _j(pm))
    got = TM.mutual_nearest_candidates(conf_t, 0.2, 1, (h, w), (h, w),
                                       _t(pm), _t(pm))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.j_ids.numpy(), np.asarray(want.j_ids))


def test_topk_keeps_lowest_index_on_ties():
    """Every invalid slot scores -1: ids must follow jax.lax.top_k's
    lowest-index-first order in every slot."""
    r = np.random.RandomState(9)
    valid = r.rand(2, 40) > 0.7
    mconf = np.where(valid, r.rand(2, 40).astype(np.float32), 0.0)
    mconf[0, 3] = mconf[0, 5] = 0.5          # an exact tie among valid
    valid[0, 3] = valid[0, 5] = True
    j_ids = r.randint(0, 40, (2, 40)).astype(np.int32)
    want = JM.topk_matches(JM.CandidateMatches(
        jnp.asarray(j_ids), jnp.asarray(mconf), jnp.asarray(valid)), 16)
    got = TM.topk_matches(TM.CandidateMatches(
        _t(j_ids), _t(mconf), _t(valid)), 16)
    for name in ("i_ids", "j_ids", "mconf", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_matches_to_kpts_with_scales():
    r = np.random.RandomState(10)
    i_ids = r.randint(0, 48, (2, 5)).astype(np.int32)
    j_ids = r.randint(0, 42, (2, 5)).astype(np.int32)
    sc = r.rand(2, 2).astype(np.float32) + 0.5
    mk = dict(mconf=np.zeros((2, 5), np.float32), mask=np.ones((2, 5), bool),
              gt_mask=np.zeros((2, 5), bool))
    from loftr_tpu.structs import CoarseMatches as JCM
    from loftr_tpu_torch.structs import CoarseMatches as TCM
    want = JM.matches_to_kpts(
        JCM(i_ids=jnp.asarray(i_ids), j_ids=jnp.asarray(j_ids),
            **{k: jnp.asarray(v) for k, v in mk.items()}),
        (6, 8), (6, 7), 8, jnp.asarray(sc), jnp.asarray(sc))
    got = TM.matches_to_kpts(
        TCM(i_ids=_t(i_ids), j_ids=_t(j_ids),
            **{k: _t(v) for k, v in mk.items()}),
        (6, 8), (6, 7), 8, _t(sc), _t(sc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
