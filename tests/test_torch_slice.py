"""PyTorch port: the whole inference slice against the JAX package.

The small config of tests/test_model.py with all three ``use_pallas``
switches on (JAX: Pallas kernels in interpret mode; port on the CPU: the
kernel modules' plain versions), thr=0 and border_rm=0 so most slots hold
matches, 64x64 images, one seeded JAX init converted to the port.  The
fields compared are those tests/golden/make_golden.py records.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu import LoFTR as JaxLoFTR, MatchInput as JaxMatchInput
from loftr_tpu import get_config as jax_get_config
from loftr_tpu_torch import LoFTR, MatchInput, get_config
from loftr_tpu_torch.api import match_pair
from loftr_tpu_torch.utils.weights import state_dict_from_jax


def _over(use_pallas, B=1):
    return {"loftr": {
        "backbone": {"initial_dim": 16, "block_dims": (16, 24, 32)},
        "coarse": {"d_model": 32, "nhead": 4,
                   "layer_names": ("self", "cross"), "use_pallas": use_pallas},
        "fine": {"d_model": 16, "nhead": 2, "layer_names": ("self", "cross"),
                 "use_pallas": use_pallas},
        "match_coarse": {"max_matches": 16, "thr": 0.0, "border_rm": 0,
                         "use_pallas": use_pallas}}}


def _inputs(B, seed, masked):
    r = np.random.RandomState(seed)
    i0 = r.rand(B, 64, 64, 1).astype(np.float32)
    i1 = r.rand(B, 64, 64, 1).astype(np.float32)
    kw = {}
    if masked:
        m = np.zeros((B, 8, 8), bool)
        m[:, :6, :7] = True
        sc = np.full((B, 2), 2.0, np.float32)
        kw = dict(mask0=m, mask1=m, scale0=sc, scale1=sc)
    return i0, i1, kw


def _pair(use_pallas, B=1, seed=0, masked=False):
    i0, i1, kw = _inputs(B, seed, masked)
    jcfg = jax_get_config("indoor_ds", _over(use_pallas))
    jm = JaxLoFTR(jcfg.loftr)
    jinp = JaxMatchInput(image0=jnp.asarray(i0), image1=jnp.asarray(i1),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    v = jm.init(jax.random.PRNGKey(seed), jinp)
    want = jm.apply(v, jinp)
    model = LoFTR(get_config("indoor_ds", _over(use_pallas)).loftr)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, dict(v))))
    tinp = MatchInput(image0=torch.from_numpy(i0), image1=torch.from_numpy(i1),
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    return want, model.eval(), tinp


def _np(x):
    return np.asarray(x, dtype=np.float64) if not isinstance(
        x, torch.Tensor) else x.double().numpy()


def assert_slice_equal(got, want):
    """valid, i_ids, j_ids exactly in every slot -- except that slots whose
    valid mconf values lie within 1e-6 of each other may swap order, so
    those compare as sets; mconf, expec_f, mkpts*_f within fp32 bars."""
    v_w = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v_w)
    gi, gj = got.coarse.i_ids.numpy(), got.coarse.j_ids.numpy()
    wi, wj = np.asarray(want.coarse.i_ids), np.asarray(want.coarse.j_ids)
    wc = np.asarray(want.coarse.mconf)
    for b in range(wi.shape[0]):
        vb = v_w[b]
        d = np.abs(wc[b][:, None] - wc[b][None, :])
        close = (d < 1e-6) & vb[:, None] & vb[None, :]
        np.fill_diagonal(close, False)
        near = close.any(axis=1)
        np.testing.assert_array_equal(gi[b][~near], wi[b][~near])
        np.testing.assert_array_equal(gj[b][~near], wj[b][~near])
        assert (sorted(zip(gi[b][near], gj[b][near]))
                == sorted(zip(wi[b][near], wj[b][near])))
    same = (gi == wi) & (gj == wj)
    # fp32 bars: mconf as test_pallas_match.py:43; expec_f as
    # test_fine_stage_fused.py:65; keypoints in pixels
    np.testing.assert_allclose(got.coarse.mconf.numpy(), wc, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(_np(got.expec_f)[same],
                               _np(want.expec_f)[same], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(got.mkpts0_f)[same],
                               _np(want.mkpts0_f)[same], atol=1e-4)
    np.testing.assert_allclose(_np(got.mkpts1_f)[same],
                               _np(want.mkpts1_f)[same], atol=1e-3)
    np.testing.assert_allclose(_np(got.mkpts0_c), _np(want.mkpts0_c)[...],
                               atol=1e-5)


@pytest.mark.parametrize("use_pallas,B,masked", [
    (True, 1, False), (True, 2, True), (False, 1, False)])
def test_slice_matches_jax(use_pallas, B, masked):
    want, model, inp = _pair(use_pallas, B=B, seed=B, masked=masked)
    got = model(inp)
    assert int(np.asarray(want.valid).sum()) > 0
    assert_slice_equal(got, want)


def test_match_pair_matches_jax_forward():
    """The port's match_pair (CPU, float32) returns the JAX forward's valid
    matches: the reference's {mkpts0, mkpts1, mconf} contract."""
    want, model, inp = _pair(True, seed=5)
    img0 = inp.image0[0, :, :, 0].numpy()
    img1 = inp.image1[0, :, :, 0].numpy()
    out = match_pair(img0, img1, model, dtype="float32")
    assert set(out) == {"mkpts0", "mkpts1", "mconf"}
    keep = np.asarray(want.valid)[0]
    assert keep.any()
    order = np.argsort(-np.asarray(want.coarse.mconf)[0][keep], kind="stable")
    np.testing.assert_allclose(out["mconf"],
                               np.asarray(want.coarse.mconf)[0][keep][order],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out["mkpts1"],
                               np.asarray(want.mkpts1_f)[0][keep][order],
                               atol=1e-3)
    np.testing.assert_allclose(out["mkpts0"],
                               np.asarray(want.mkpts0_f)[0][keep][order],
                               atol=1e-4)


def test_match_pair_bf16_runs_on_cpu():
    from loftr_tpu_torch.utils.weights import init_weights
    model = init_weights(
        LoFTR(get_config("indoor_ds", _over(True)).loftr), 6).eval()
    i0, _, _ = _inputs(1, 6, False)
    img = (i0[0, :, :, 0] * 255).astype(np.uint8)
    out = match_pair(img, img, model)          # default dtype bfloat16
    assert out["mkpts0"].shape == out["mkpts1"].shape
    assert np.isfinite(out["mkpts1"]).all() and np.isfinite(out["mconf"]).all()
