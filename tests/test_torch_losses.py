"""PyTorch port: losses against the JAX package (loftr_tpu_torch.losses vs
loftr_tpu.losses), and the focal-loss kernel module's plain version against
the Pallas kernel pair in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loftr_tpu.config as jcfg
import loftr_tpu_torch.config as tcfg
from loftr_tpu import losses as JL
from loftr_tpu.ops.pallas.focal_loss import fused_focal_sums as jax_focal_sums
from loftr_tpu.structs import (CoarseMatches as JaxCoarseMatches,
                               MatchInput as JaxMatchInput,
                               MatchResult as JaxMatchResult,
                               Supervision as JaxSupervision)
from loftr_tpu_torch import losses as TL
from loftr_tpu_torch.ops.kernels.focal_loss import (focal_sums_plain,
                                                    fused_focal_sums)
from loftr_tpu_torch.structs import (CoarseMatches, MatchInput, MatchResult,
                                     Supervision)


def _conf_case(B=2, L=20, S=24, seed=0, with_bin=False):
    rng = np.random.RandomState(seed)
    n0, n1 = L + with_bin, S + with_bin
    logits = rng.randn(B, n0, n1).astype(np.float32) * 2
    conf = np.exp(logits) / np.exp(logits).sum(axis=2, keepdims=True)
    conf[0, 1, 2] = 0.0          # below the clamp
    conf[0, 2, 3] = 1.0          # above the clamp
    gt = np.zeros((B, L, S), bool)
    for b in range(B):
        ii = rng.permutation(L)[:6]
        jj = rng.permutation(S)[:6]
        gt[b, ii, jj] = True
    m0 = np.ones((B, L), np.float32)
    m1 = np.ones((B, S), np.float32)
    m0[:, -3:] = 0
    m1[:, -5:] = 0
    weight = m0[:, :, None] * m1[:, None, :]
    return conf.astype(np.float32), gt, weight


def _grad_pair(jfn, tfn, x):
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tv = tfn(xt)
    tv.backward()
    return float(jv), np.asarray(jg), float(tv.detach()), xt.grad.numpy()


@pytest.mark.parametrize("coarse_type,sparse,match_type,weighted", [
    ("cross_entropy", False, "dual_softmax", False),
    ("cross_entropy", False, "dual_softmax", True),
    ("focal", True, "dual_softmax", True),
    ("focal", True, "sinkhorn", False),
    ("focal", True, "sinkhorn", True),
    ("focal", False, "dual_softmax", False),
    ("focal", False, "dual_softmax", True),
])
def test_coarse_loss_matches_jax(coarse_type, sparse, match_type, weighted):
    with_bin = match_type == "sinkhorn" and sparse
    conf, gt, weight = _conf_case(with_bin=with_bin)
    jl = jcfg.LossConfig(coarse_type=coarse_type, pos_weight=0.7,
                         neg_weight=1.3)
    tl = tcfg.LossConfig(coarse_type=coarse_type, pos_weight=0.7,
                         neg_weight=1.3)
    jm = jcfg.MatchCoarseConfig(sparse_spvs=sparse, match_type=match_type)
    tm = tcfg.MatchCoarseConfig(sparse_spvs=sparse, match_type=match_type)
    jw = jnp.asarray(weight) if weighted else None
    tw = torch.from_numpy(weight) if weighted else None

    if with_bin:
        jfn = lambda c: JL.coarse_loss(c[:, :-1, :-1], jnp.asarray(gt), jl,
                                       jm, jw, conf_with_bin=c)
        tfn = lambda c: TL.coarse_loss(c[:, :-1, :-1], torch.from_numpy(gt),
                                       tl, tm, tw, conf_with_bin=c)
    else:
        jfn = lambda c: JL.coarse_loss(c, jnp.asarray(gt), jl, jm, jw)
        tfn = lambda c: TL.coarse_loss(c, torch.from_numpy(gt), tl, tm, tw)
    jv, jg, tv, tg = _grad_pair(jfn, tfn, conf)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-7)


def test_coarse_loss_empty_masks_give_zero():
    conf, gt, _ = _conf_case()
    tl, tm = tcfg.LossConfig(), tcfg.MatchCoarseConfig(sparse_spvs=True)
    got = TL.coarse_loss(torch.from_numpy(conf),
                         torch.zeros_like(torch.from_numpy(gt)), tl, tm)
    assert float(got) == 0.0
    with pytest.raises(NotImplementedError):
        TL.coarse_loss(torch.from_numpy(conf), torch.from_numpy(gt),
                       tcfg.LossConfig(coarse_type="cross_entropy"), tm)


@pytest.mark.parametrize("fine_type,masked", [("l2", False), ("l2", True),
                                              ("l2_with_std", False),
                                              ("l2_with_std", True)])
def test_fine_loss_matches_jax(fine_type, masked):
    rng = np.random.RandomState(1)
    expec = np.concatenate([rng.randn(2, 12, 2) * 0.4,
                            rng.rand(2, 12, 1) + 0.05], -1).astype(np.float32)
    gt = (rng.randn(2, 12, 2) * 0.7).astype(np.float32)   # some beyond thr
    mask = rng.rand(2, 12) > 0.3 if masked else None
    jl = jcfg.LossConfig(fine_type=fine_type)
    tl = tcfg.LossConfig(fine_type=fine_type)
    jv, jg, tv, tg = _grad_pair(
        lambda e: JL.fine_loss(e, jnp.asarray(gt), jl,
                               None if mask is None else jnp.asarray(mask)),
        lambda e: TL.fine_loss(e, torch.from_numpy(gt), tl,
                               None if mask is None
                               else torch.from_numpy(mask)), expec)
    assert (np.abs(gt).max(-1) >= 1.0).any()
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    # the std column's gradient is zero on both sides (detached weight)
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-7)
    if fine_type == "l2_with_std":
        assert np.all(tg[..., 2] == 0)


def test_fine_loss_no_correct_slot_gives_zero():
    e = torch.zeros(1, 4, 3)
    gt = torch.full((1, 4, 2), 2.0)
    assert float(TL.fine_loss(e, gt, tcfg.LossConfig())) == 0.0


def test_compute_c_weight_matches_jax():
    rng = np.random.RandomState(2)
    img = np.zeros((2, 32, 32, 1), np.float32)
    m0, m1 = rng.rand(2, 4, 4) > 0.3, rng.rand(2, 4, 4) > 0.3
    want = JL.compute_c_weight(JaxMatchInput(
        image0=jnp.asarray(img), image1=jnp.asarray(img),
        mask0=jnp.asarray(m0), mask1=jnp.asarray(m1)))
    got = TL.compute_c_weight(MatchInput(
        image0=torch.from_numpy(img), image1=torch.from_numpy(img),
        mask0=torch.from_numpy(m0), mask1=torch.from_numpy(m1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TL.compute_c_weight(MatchInput(
        image0=torch.from_numpy(img), image1=torch.from_numpy(img))) is None


# ---- the focal function: plain version vs the Pallas kernels ---------------

def _focal_case(L, S, C, n_gt, seed=0, masked=False):
    """The cases of tests/test_pallas_loss.py::_case."""
    rng = np.random.RandomState(seed)
    f0 = rng.randn(L, C).astype(np.float32)
    f1 = rng.randn(S, C).astype(np.float32)
    f0 /= np.linalg.norm(f0, axis=-1, keepdims=True)
    f1 /= np.linalg.norm(f1, axis=-1, keepdims=True)
    gt_j = np.zeros(L, np.int32)
    gt_valid = np.zeros(L, bool)
    ii = rng.permutation(L)[:n_gt]
    jj = rng.permutation(S)[:n_gt]
    for i, j in zip(ii, jj):
        f1[j] = f0[i] + rng.randn(C).astype(np.float32) * 0.2
        gt_j[i] = j
        gt_valid[i] = True
    f0 *= 3
    f1 *= 3
    m0 = m1 = None
    if masked:
        m0 = np.ones(L, bool)
        m0[-L // 5:] = False
        m1 = np.ones(S, bool)
        m1[-S // 7:] = False
    return f0, f1, gt_j, gt_valid, m0, m1


@pytest.mark.parametrize("shape,n_gt,seed,masked", [
    ((64, 64, 16), 10, 0, False), ((96, 80, 16), 10, 0, False),
    ((64, 64, 16), 10, 0, True), ((32, 32, 8), 0, 3, False),
    ((320, 192, 32), 24, 5, False)])
def test_focal_sums_plain_matches_pallas(shape, n_gt, seed, masked):
    """Sums to 1e-5, gradients to 1e-3 / 1e-7: the bars of
    tests/test_pallas_loss.py (the Pallas kernels against jax.grad)."""
    L, S, C = shape
    f0, f1, gt_j, gt_valid, m0, m1 = _focal_case(L, S, C, n_gt, seed, masked)
    gp, gn = 0.37, 1.9          # distinct upstream cotangents

    def jfn(a, b):
        p, n = jax_focal_sums(a, b, 0.1, jnp.asarray(gt_j),
                              jnp.asarray(gt_valid),
                              None if m0 is None else jnp.asarray(m0),
                              None if m1 is None else jnp.asarray(m1),
                              0.25, 2.0, 128, True)
        return gp * p + gn * n, (p, n)

    (_, (wp, wn)), (wd0, wd1) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(jnp.asarray(f0), jnp.asarray(f1))

    a = torch.from_numpy(f0)[None].requires_grad_(True)
    b = torch.from_numpy(f1)[None].requires_grad_(True)
    t = lambda x: None if x is None else torch.from_numpy(x)[None]
    p, n = fused_focal_sums(a, b, t(gt_j), t(gt_valid), t(m0), t(m1), 0.1,
                            0.25, 2.0)      # CPU tensors: the plain version
    (gp * p.sum() + gn * n.sum()).backward()
    np.testing.assert_allclose(float(p), float(wp), rtol=1e-5)
    np.testing.assert_allclose(float(n), float(wn), rtol=1e-5)
    assert np.isfinite(a.grad.numpy()).all()
    np.testing.assert_allclose(a.grad[0].numpy(), np.asarray(wd0), rtol=1e-3,
                               atol=1e-7)
    np.testing.assert_allclose(b.grad[0].numpy(), np.asarray(wd1), rtol=1e-3,
                               atol=1e-7)


def test_focal_sums_runtime_gamma_and_bf16():
    """gamma != 2 goes through pow; bfloat16 features are cast to float32
    and the gradients come back in bfloat16."""
    f0, f1, gt_j, gt_valid, _, _ = _focal_case(64, 48, 16, 8, seed=7)
    t = lambda x: torch.from_numpy(x)[None]
    a = t(f0).requires_grad_(True)
    p, n = focal_sums_plain(a, t(f1), t(gt_j), t(gt_valid), gamma=1.5)
    wp, wn = jax_focal_sums(jnp.asarray(f0), jnp.asarray(f1), 0.1,
                            jnp.asarray(gt_j), jnp.asarray(gt_valid), None,
                            None, 0.25, 1.5, 128, True)
    np.testing.assert_allclose(float(p), float(wp), rtol=1e-5)
    np.testing.assert_allclose(float(n), float(wn), rtol=1e-5)
    ab = t(f0).bfloat16().requires_grad_(True)
    pb, nb = focal_sums_plain(ab, t(f1).bfloat16(), t(gt_j), t(gt_valid))
    (pb.sum() + nb.sum()).backward()
    assert pb.dtype == torch.float32 and ab.grad.dtype == torch.bfloat16


def test_focal_kernel_refuses_what_it_does_not_take():
    from loftr_tpu_torch.ops.kernels.focal_loss import _check
    f = torch.zeros(1, 8, 16)
    g = torch.zeros(1, 8, dtype=torch.int32)
    _check(f, f, g, g)
    with pytest.raises(ValueError):
        _check(f, torch.zeros(1, 8, 32), g, g)
    with pytest.raises(ValueError):
        _check(torch.zeros(1, 8, 512), torch.zeros(1, 8, 512), g, g)
    with pytest.raises(ValueError):
        _check(f, f, g[:, :4], g)
    with pytest.raises(ValueError):
        _check(f.transpose(1, 2), f.transpose(1, 2), g, g)


# ---- the batch loss through the fused route --------------------------------

def _result_pair(B=2, L=64, S=48, C=16, masked=False, seed=11):
    rng = np.random.RandomState(seed)
    cases = [_focal_case(L, S, C, 6 + 3 * b, seed + b) for b in range(B)]
    f0 = np.stack([c[0] for c in cases])
    f1 = np.stack([c[1] for c in cases])
    gt_j = np.stack([c[2] for c in cases])
    gt_valid = np.stack([c[3] for c in cases])
    K = 5
    expec = rng.randn(B, K, 3).astype(np.float32) * 0.3
    expec[..., 2] = np.abs(expec[..., 2]) + 0.1
    expec_gt = rng.randn(B, K, 2).astype(np.float32) * 0.5
    ids = rng.randint(0, 40, (B, K)).astype(np.int32)
    mask = np.ones((B, K), bool)
    img = np.zeros((B, 64, 48 if S == 48 else 64, 1), np.float32)
    m0 = m1 = None
    if masked:
        m0 = np.ones((B, 8, 8), bool)
        m0[:, 6:] = False
        m1 = np.ones((B, 8, 6), bool)
        m1[:, :, 5:] = False
    return dict(f0=f0, f1=f1, gt_j=gt_j, gt_valid=gt_valid, expec=expec,
                expec_gt=expec_gt, ids=ids, mask=mask, img=img, m0=m0, m1=m1)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_coarse_loss_matches_jax_and_dense_route(masked):
    """B=2 with different GT counts per pair: the denominators are
    batch-global.  Against the JAX fused route (Pallas, interpret) and
    against the port's own dense route through dual_softmax_conf."""
    from loftr_tpu_torch.ops.matching import dual_softmax_conf
    d = _result_pair(masked=masked)
    B = d["f0"].shape[0]
    jl, jm = jcfg.LossConfig(), jcfg.MatchCoarseConfig(sparse_spvs=False)
    tl, tm = tcfg.LossConfig(), tcfg.MatchCoarseConfig(sparse_spvs=False)
    jn = lambda x: None if x is None else jnp.asarray(x)
    tn = lambda x: None if x is None else torch.from_numpy(x)
    zeros = np.zeros_like(d["expec"][..., :2])

    def jres(f0, f1):
        cm = JaxCoarseMatches(i_ids=jn(d["ids"]), j_ids=jn(d["ids"]),
                              mconf=jn(d["expec"][..., 0]),
                              mask=jn(d["mask"]), gt_mask=jn(~d["mask"]))
        return JaxMatchResult(coarse=cm, mkpts0_c=jn(zeros),
                              mkpts1_c=jn(zeros), mkpts0_f=jn(zeros),
                              mkpts1_f=jn(zeros), expec_f=jn(d["expec"]),
                              feat_c0=f0, feat_c1=f1)

    jspv = JaxSupervision(gt_j=jn(d["gt_j"]), gt_valid=jn(d["gt_valid"]),
                          w_pt0_i=jn(np.zeros((B, 64, 2), np.float32)),
                          pt1_i=jn(np.zeros((B, 48, 2), np.float32)))
    jinp = JaxMatchInput(image0=jn(np.zeros((B, 64, 64, 1), np.float32)),
                         image1=jn(np.zeros((B, 64, 48, 1), np.float32)),
                         mask0=jn(d["m0"]), mask1=jn(d["m1"]))

    def jloss(f0, f1):
        # Pallas in interpret mode: the kernels take interpret from the
        # backend (CPU), as under loss.force_pallas_cpu
        loss, sc = JL.loftr_loss(jres(f0, f1), jspv, jn(d["expec_gt"]), jinp,
                                 jl, jm)
        return loss, sc

    (wl, wsc), (wd0, wd1) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jn(d["f0"]), jn(d["f1"]))

    def tres(f0, f1, conf=None):
        cm = CoarseMatches(i_ids=tn(d["ids"]), j_ids=tn(d["ids"]),
                           mconf=tn(d["expec"][..., 0]), mask=tn(d["mask"]),
                           gt_mask=tn(~d["mask"]))
        return MatchResult(coarse=cm, mkpts0_c=tn(zeros), mkpts1_c=tn(zeros),
                           mkpts0_f=tn(zeros), mkpts1_f=tn(zeros),
                           expec_f=tn(d["expec"]), conf_matrix=conf,
                           feat_c0=None if conf is not None else f0,
                           feat_c1=None if conf is not None else f1)

    tspv = Supervision(gt_j=tn(d["gt_j"]), gt_valid=tn(d["gt_valid"]),
                       w_pt0_i=torch.zeros(B, 64, 2),
                       pt1_i=torch.zeros(B, 48, 2))
    tinp = MatchInput(image0=torch.zeros(B, 64, 64, 1),
                      image1=torch.zeros(B, 64, 48, 1), mask0=tn(d["m0"]),
                      mask1=tn(d["m1"]))
    for route in ("fused", "dense"):
        a = tn(d["f0"]).requires_grad_(True)
        b = tn(d["f1"]).requires_grad_(True)
        conf = None
        if route == "dense":
            mc0 = None if d["m0"] is None else tn(d["m0"]).reshape(B, -1)
            mc1 = None if d["m1"] is None else tn(d["m1"]).reshape(B, -1)
            conf = dual_softmax_conf(a, b, 0.1, mc0, mc1)
        loss, sc = TL.loftr_loss(tres(a, b, conf), tspv, tn(d["expec_gt"]),
                                 tinp, tl, tm)
        loss.backward()
        np.testing.assert_allclose(float(sc["loss_c"]), float(wsc["loss_c"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(sc["loss_f"]), float(wsc["loss_f"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(loss), float(wl), rtol=1e-5)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(wd0),
                                   rtol=1e-3, atol=1e-7)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(wd1),
                                   rtol=1e-3, atol=1e-7)
    with pytest.raises(ValueError):
        r = tres(None, None)
        TL.loftr_loss(r, tspv, tn(d["expec_gt"]), tinp, tl, tm)
