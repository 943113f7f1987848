"""PyTorch port: ground-truth supervision against the JAX package
(loftr_tpu_torch.supervision vs loftr_tpu.supervision).  Ids exact, floats
to 1e-5 (float32 on both sides; only the summation order of the 3x3
products differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu import supervision as JS
from loftr_tpu.structs import CoarseMatches as JaxCoarseMatches
from loftr_tpu_torch import supervision as TS
from loftr_tpu_torch.structs import CoarseMatches

from torch_train_common import to_jax, to_torch, train_batch


@pytest.mark.parametrize("moved", [False, True])
def test_warp_kpts_matches_jax(moved):
    b = train_batch(B=2, seed=1, moved=moved)
    rng = np.random.RandomState(2)
    kpts = (rng.rand(2, 50, 2) * 63).astype(np.float32)
    b["depth0"][0, :8, :8] = 0.0        # zero depth: invalid, degenerate warp
    want_v, want_w = JS.warp_kpts(
        jnp.asarray(kpts), *(jnp.asarray(b[k]) for k in
                             ("depth0", "depth1", "T_0to1", "K0", "K1")))
    got_v, got_w = TS.warp_kpts(
        torch.from_numpy(kpts), *(torch.from_numpy(b[k]) for k in
                                  ("depth0", "depth1", "T_0to1", "K0", "K1")))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("moved,masked", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_coarse_supervision_matches_jax(moved, masked):
    b = train_batch(B=2, seed=3, moved=moved, masked=masked)
    if masked:
        b["scale0"][:] = (1.5, 1.25)
        b["scale1"][:] = (1.5, 1.25)
        b["K0"][:, :2] *= 1.4
        b["K1"][:, :2] *= 1.4
        for k in ("depth0", "depth1"):
            b[k] = np.kron(b[k], np.ones((2, 2), np.float32))
    want = JS.coarse_supervision(to_jax(b), 8)
    got = TS.coarse_supervision(to_torch(b), 8)
    assert int(np.asarray(want.gt_valid).sum()) > 0
    assert got.gt_j.dtype == torch.int32
    np.testing.assert_array_equal(got.gt_j.numpy(), np.asarray(want.gt_j))
    np.testing.assert_array_equal(got.gt_valid.numpy(),
                                  np.asarray(want.gt_valid))
    np.testing.assert_allclose(got.w_pt0_i.numpy(), np.asarray(want.w_pt0_i),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.pt1_i.numpy(), np.asarray(want.pt1_i),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.num_gt.numpy(), np.asarray(want.num_gt))
    np.testing.assert_array_equal(got.conf_matrix_gt(64).numpy(),
                                  np.asarray(want.conf_matrix_gt(64)))


def test_identity_pose_gives_the_diagonal():
    got = TS.coarse_supervision(to_torch(train_batch(B=1, seed=4)), 8)
    # border cells warp outside the covisible range only through rounding;
    # every valid row points at itself
    rows = torch.arange(64)[None]
    assert bool((got.gt_j[got.gt_valid] == rows[got.gt_valid]).all())
    assert int(got.gt_valid.sum()) >= 60
    assert not bool(got.gt_valid[0, 0])


@pytest.mark.parametrize("scaled", [False, True])
def test_fine_supervision_matches_jax(scaled):
    b = train_batch(B=2, seed=5, moved=True, masked=scaled)
    rng = np.random.RandomState(6)
    i_ids = rng.randint(0, 64, (2, 10)).astype(np.int32)
    j_ids = rng.randint(0, 64, (2, 10)).astype(np.int32)
    z = np.zeros((2, 10), np.float32)
    jm = JaxCoarseMatches(i_ids=jnp.asarray(i_ids), j_ids=jnp.asarray(j_ids),
                          mconf=jnp.asarray(z), mask=jnp.asarray(z > -1),
                          gt_mask=jnp.asarray(z > 0))
    tm = CoarseMatches(i_ids=torch.from_numpy(i_ids),
                       j_ids=torch.from_numpy(j_ids),
                       mconf=torch.from_numpy(z),
                       mask=torch.from_numpy(z > -1),
                       gt_mask=torch.from_numpy(z > 0))
    jb, tb = to_jax(b), to_torch(b)
    want = JS.fine_supervision(JS.coarse_supervision(jb, 8), jm, jb, 2, 5)
    got = TS.fine_supervision(TS.coarse_supervision(tb, 8), tm, tb, 2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
