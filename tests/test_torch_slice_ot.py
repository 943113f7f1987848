"""PyTorch port: the OT inference slice against the JAX package.

The small config of tests/test_torch_slice.py with ``indoor_ot``
(``match_type="sinkhorn"``): the JAX package with ``use_pallas`` on runs its
Pallas Sinkhorn kernel in interpret mode, the port on the CPU its kernel
module's plain version; with ``use_pallas`` off both take ``sinkhorn_conf``.
thr=0 and border_rm=0 so most slots hold matches; one seeded JAX init
(``bin_score`` included) converted to the port.  An untrained net's coarse
features have so little contrast that the dustbin wins every row, whatever
``bin_score`` (its potential absorbs the score), so the tests scale the last
coarse LayerNorm by 6: then some cells beat the dustbin and some do not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu import LoFTR as JaxLoFTR, MatchInput as JaxMatchInput
from loftr_tpu import get_config as jax_get_config
from loftr_tpu_torch import LoFTR, MatchInput, get_config
from loftr_tpu_torch.api import load_matcher, match_pair
from loftr_tpu_torch.ops.kernels.sinkhorn import fused_sinkhorn_match
from loftr_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_slice import _inputs, _over, assert_slice_equal


def _ot_over(use_pallas, prefilter):
    over = _over(use_pallas)
    over["loftr"]["match_coarse"]["skh_prefilter"] = prefilter
    return over


def _pair(preset, use_pallas, prefilter, B, seed, masked, contrast=6.0):
    i0, i1, kw = _inputs(B, seed, masked)
    over = _ot_over(use_pallas, prefilter)
    jm = JaxLoFTR(jax_get_config(preset, over).loftr)
    jinp = JaxMatchInput(image0=jnp.asarray(i0), image1=jnp.asarray(i1),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    v = jax.tree.map(np.asarray, dict(jm.init(jax.random.PRNGKey(seed),
                                              jinp)))
    assert v["params"]["bin_score"].shape == ()
    if contrast is not None:
        ln = v["params"]["loftr_coarse"]["layer_1"]["norm2"]
        ln["scale"] = np.full_like(ln["scale"], contrast)
    want = jm.apply(v, jinp)
    model = LoFTR(get_config(preset, over).loftr)
    model.load_state_dict(state_dict_from_jax(v))
    tinp = MatchInput(image0=torch.from_numpy(i0), image1=torch.from_numpy(i1),
                      **{k: torch.from_numpy(x) for k, x in kw.items()})
    return want, model.eval(), tinp


@pytest.mark.parametrize("use_pallas,prefilter,B,masked", [
    (True, False, 1, False), (True, True, 2, True), (True, True, 1, False),
    (False, False, 1, False), (False, True, 2, True)])
def test_ot_slice_matches_jax(use_pallas, prefilter, B, masked):
    want, model, inp = _pair("indoor_ot", use_pallas, prefilter, B, seed=B,
                             masked=masked)
    got = model(inp)
    assert int(np.asarray(want.valid).sum()) > 0
    assert_slice_equal(got, want)
    assert got.conf_matrix_with_bin is None      # dense supervision preset
    assert (got.conf_matrix is None) == use_pallas
    # the prefilter drops some columns here, not all and not none
    f = model.coarse(model.extract(inp))
    flags = fused_sinkhorn_match(f.feat_c0, f.feat_c1,
                                 model.coarse_matching.bin_score, 3,
                                 f.mask_c0, f.mask_c1)[4]
    assert flags.any() and not flags.all()


def test_ot_slice_at_the_initial_bin_score():
    """The seeded init's own bin_score (skh_init_bin_score = 1.0), as
    tests/test_model.py::test_pallas_path_equals_xla_path runs it."""
    want, model, inp = _pair("indoor_ot", True, False, 1, seed=3,
                             masked=False, contrast=None)
    assert model.coarse_matching.bin_score.item() == 1.0
    assert_slice_equal(model(inp), want)


@pytest.mark.parametrize("preset", ["outdoor_ot", "indoor_ot_buggy_pos_enc"])
def test_other_ot_presets_match_jax(preset):
    want, model, inp = _pair(preset, True, True, 1, seed=4, masked=False)
    assert int(np.asarray(want.valid).sum()) > 0
    assert_slice_equal(model(inp), want)


def test_sparse_supervision_returns_the_assignment():
    over = _ot_over(False, False)
    over["loftr"]["match_coarse"]["sparse_spvs"] = True
    model = LoFTR(get_config("indoor_ot", over).loftr).eval()
    i0, i1, _ = _inputs(1, 0, False)
    out = model(MatchInput(image0=torch.from_numpy(i0),
                           image1=torch.from_numpy(i1)))
    assert out.conf_matrix.shape == (1, 64, 64)
    assert out.conf_matrix_with_bin.shape == (1, 65, 65)
    assert torch.equal(out.conf_matrix_with_bin[:, :-1, :-1], out.conf_matrix)


def test_load_matcher_and_match_pair_take_the_ot_presets():
    for preset in ("indoor_ot", "outdoor_ot", "indoor_ot_buggy_pos_enc"):
        m = load_matcher(preset=preset, seed=1, device="cpu")
        assert "coarse_matching.bin_score" in m.state_dict()
        assert m.coarse_matching.bin_score.item() == 1.0
    assert "coarse_matching.bin_score" not in load_matcher(
        preset="indoor_ds", device="cpu").state_dict()
    model = LoFTR(get_config("indoor_ot", _ot_over(True, True)).loftr).eval()
    img = (np.random.RandomState(2).rand(64, 64) * 255).astype(np.uint8)
    out = match_pair(img, img, model, dtype="float32")
    assert set(out) == {"mkpts0", "mkpts1", "mconf"}
    assert out["mkpts0"].shape == out["mkpts1"].shape
    assert np.isfinite(out["mconf"]).all()
