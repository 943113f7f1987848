"""PyTorch port: kernel D (the fused focal loss) in bfloat16 against the JAX
Pallas kernel (interpret mode), and a plain model of the pass structure of
its bfloat16 CUDA path.

The JAX kernel scales the features by s = 1/sqrt(C*T) and, for bfloat16
features, rounds s and each scaled feature to bfloat16 before any pass;
``focal_sums_plain`` forms the same copies (value bf16(f * bf16(s)), slope
s).  ``test_plain_bf16_matches_jax`` holds it to
``loftr_tpu/ops/pallas/focal_loss.py::fused_focal_sums`` at three shapes.

The CUDA passes run only on the card (``chip_smoke.py`` phase 2).  Here a
plain model of their structure is held against the same JAX kernel and
against the JAX backward's own quantities: the loss pass's class-split row
and column sums of a = focal'(conf) w conf, combined with (gpos, gneg),
equal the first backward pass's Srow and Scol; the gradient grids' partial
products over the chunks of ``grad_plan``, added in ascending order, equal
the unchunked product; and dsim split into bf16 hi + lo halves times bf16
features stays within 2^-16 of the float product.  Of the port these model
tests run only ``feature_scale``, ``loss_plan`` and ``grad_plan``.

Bars: sums rtol 1e-5; gradients 8e-3 of the entry plus 2e-3 of the pair's
largest entry (both sides round the float gradient to bfloat16 once, so
entries may differ by one bf16 ulp), the bar of ``chip_smoke.py`` phase 2.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.ops.pallas.focal_loss import fused_focal_sums as jax_focal_sums
from loftr_tpu_torch.ops.kernels import focal_loss as KD

T, ALPHA = 0.1, 0.25
# name: (B, L, S, C, masked, gamma, n_gt per pair)
CASES = {
    "masked": (2, 96, 96, 32, True, 2.0, (12, 5)),
    "ragged": (1, 200, 150, 64, False, 2.0, (20,)),
    "gamma": (1, 64, 80, 32, False, 1.5, (9,)),
}
COT = (0.37, 1.9)   # distinct cotangents of (pos, neg)


def _case(name):
    """bf16-representable features of 0.77 a channel (sim of a planted
    pair about 6 against N(0, 0.6)), n_gt ground-truth pairs and as many
    look-alikes that are not ground truth, so that positives and negatives
    with a live gradient both exist."""
    B, L, S, C, masked, gamma, n_gt = CASES[name]
    rng = np.random.RandomState(L * 31 + S)
    f0 = (rng.randn(B, L, C) * 0.77).astype(np.float32)
    f1 = (rng.randn(B, S, C) * 0.77).astype(np.float32)
    gt_j = np.zeros((B, L), np.int32)
    gt_valid = np.zeros((B, L), bool)
    for b in range(B):
        n = 2 * n_gt[b]
        ii, jj = rng.permutation(L)[:n], rng.permutation(S)[:n]
        f1[b, jj] = f0[b, ii] + 0.1 * rng.randn(n, C).astype(np.float32)
        gt_j[b, ii[:n_gt[b]]] = jj[:n_gt[b]]
        gt_valid[b, ii[:n_gt[b]]] = True
    f0 = torch.from_numpy(f0).bfloat16().float().numpy()
    f1 = torch.from_numpy(f1).bfloat16().float().numpy()
    m0 = m1 = None
    if masked:
        m0, m1 = rng.rand(B, L) > 0.15, rng.rand(B, S) > 0.15
        m0[0, :4] = False
    return f0, f1, gt_j, gt_valid, m0, m1, gamma


@functools.lru_cache(maxsize=None)
def _jax(name):
    """JAX's (pos, neg, dfeat0, dfeat1) pair by pair, bf16 features, under
    the cotangents COT (scaled apart between the pairs)."""
    f0, f1, gt_j, gt_valid, m0, m1, gamma = _case(name)
    outs = []
    for b in range(f0.shape[0]):
        gp, gn = COT[0] * (b + 1), COT[1] / (b + 1)

        def fn(a, c):
            p, n = jax_focal_sums(
                a, c, T, jnp.asarray(gt_j[b]), jnp.asarray(gt_valid[b]),
                None if m0 is None else jnp.asarray(m0[b]),
                None if m1 is None else jnp.asarray(m1[b]), ALPHA, gamma,
                128, True)
            return gp * p + gn * n, (p, n)

        (_, (p, n)), (d0, d1) = jax.value_and_grad(
            fn, argnums=(0, 1), has_aux=True)(
                jnp.asarray(f0[b], jnp.bfloat16),
                jnp.asarray(f1[b], jnp.bfloat16))
        outs.append((float(p), float(n),
                     np.asarray(d0.astype(jnp.float32)),
                     np.asarray(d1.astype(jnp.float32))))
    return (np.array([o[0] for o in outs]), np.array([o[1] for o in outs]),
            np.stack([o[2] for o in outs]), np.stack([o[3] for o in outs]))


def _cot(B):
    return (torch.tensor([COT[0] * (b + 1) for b in range(B)]),
            torch.tensor([COT[1] / (b + 1) for b in range(B)]))


def _assert_matches(p, n, d0, d1, ref):
    wp, wn, w0, w1 = ref
    np.testing.assert_allclose(p, wp, rtol=1e-5)
    np.testing.assert_allclose(n, wn, rtol=1e-5)
    for x, y in ((d0, w0), (d1, w1)):
        for xb, yb in zip(x, y):    # each pair against its own largest entry
            assert np.isfinite(xb).all()
            bar = 8e-3 * np.abs(yb) + 2e-3 * np.abs(yb).max()
            assert (np.abs(xb - yb) <= bar).all(), float(
                (np.abs(xb - yb) - bar).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bf16_matches_jax(name):
    """The port's plain version rounds bf16 features as JAX does."""
    f0, f1, gt_j, gt_valid, m0, m1, gamma = _case(name)
    t = lambda x: None if x is None else torch.from_numpy(x)
    a = t(f0).bfloat16().requires_grad_(True)
    c = t(f1).bfloat16().requires_grad_(True)
    p, n = KD.fused_focal_sums(a, c, t(gt_j), t(gt_valid), t(m0), t(m1), T,
                               ALPHA, gamma)   # CPU tensors: plain version
    gp, gn = _cot(f0.shape[0])
    ((p * gp).sum() + (n * gn).sum()).backward()
    assert a.grad.dtype == torch.bfloat16
    _assert_matches(p.detach().numpy(), n.detach().numpy(),
                    a.grad.float().numpy(), c.grad.float().numpy(),
                    _jax(name))


# ---- a plain model of the bf16 CUDA path's passes -------------------------

def _focal(conf, is_pos, gamma):
    """(value, slope) of the focal terms, the slope 0 outside the clamp."""
    c = conf.clamp(KD.EPS, 1 - KD.EPS)
    val = torch.where(is_pos, -ALPHA * (1 - c) ** gamma * torch.log(c),
                      -ALPHA * c ** gamma * torch.log1p(-c))
    dpos = -ALPHA * (-gamma * (1 - c) ** (gamma - 1) * torch.log(c)
                     + (1 - c) ** gamma / c)
    dneg = -ALPHA * (gamma * c ** (gamma - 1) * torch.log1p(-c)
                     - c ** gamma / (1 - c))
    live = (conf > KD.EPS) & (conf < 1 - KD.EPS)
    return val, torch.where(live, torch.where(is_pos, dpos, dneg), 0.0)


def _forward_model(name, sms):
    """The loss pass on the prescaled copies: per-block sums over the
    blocks of ``loss_plan``, class-split row partials per column chunk and
    column partials per 128-row tile, each combined in ascending order."""
    f0, f1, gt_j, gt_valid, m0, m1, gamma = _case(name)
    B, L, C = f0.shape
    S = f1.shape[1]
    _, sb = KD.feature_scale(C, T)
    x0 = (torch.from_numpy(f0) * sb).bfloat16().float()
    x1 = (torch.from_numpy(f1) * sb).bfloat16().float()
    w0 = torch.ones(B, L) if m0 is None else torch.from_numpy(m0).float()
    w1 = torch.ones(B, S) if m1 is None else torch.from_numpy(m1).float()
    w = w0[:, :, None] * w1[:, None, :]
    sim = x0 @ x1.transpose(1, 2) + (w - 1) * 1e9
    r = torch.softmax(sim, dim=2)
    c = torch.softmax(sim, dim=1)
    conf = r * c
    is_pos = ((torch.from_numpy(gt_j).long()[:, :, None]
               == torch.arange(S)) & torch.from_numpy(gt_valid)[:, :, None])
    val, slope = _focal(conf, is_pos, gamma)
    val, a = val * w, slope * w * conf
    rows = cols = 128
    ct, nrt, nch = KD.loss_plan(B, L, S, sms)
    pos, neg = torch.zeros(B), torch.zeros(B)
    row_p = torch.zeros(2, B, nch, L)
    col_p = torch.zeros(2, B, nrt, S)
    for rt in range(nrt):
        for ch in range(nch):
            blk = (slice(None), slice(rt * rows, (rt + 1) * rows),
                   slice(ch * ct * cols, (ch + 1) * ct * cols))
            pos += torch.where(is_pos[blk], val[blk], 0).sum(dim=(1, 2))
            neg += torch.where(is_pos[blk], 0, val[blk]).sum(dim=(1, 2))
            for k, m in enumerate((is_pos[blk], ~is_pos[blk])):
                row_p[k, :, ch, blk[1]] += torch.where(m, a[blk], 0).sum(2)
                col_p[k, :, rt, blk[2]] += torch.where(m, a[blk], 0).sum(1)
    srow2 = sum(row_p[:, :, t] for t in range(nch))
    scol2 = sum(col_p[:, :, t] for t in range(nrt))
    return dict(x0=x0, x1=x1, w=w, r=r, c=c, conf=conf, is_pos=is_pos,
                slope=slope, pos=pos, neg=neg, srow2=srow2, scol2=scol2,
                gamma=gamma)


def _split_product(d, fb):
    """(hi + lo) @ fb with hi = bf16(d), lo = bf16(d - hi), in float32."""
    hi = d.bfloat16().float()
    lo = (d - hi).bfloat16().float()
    return hi @ fb + lo @ fb


def _grad_model(m, gp, gn, sms):
    """Both gradient grids: dsim from the class-split sums folded with
    (gpos, gneg), products by the chunks of ``grad_plan`` in ascending
    order, scaled by s and rounded to bf16 once."""
    B, L, C = m["x0"].shape
    S = m["x1"].shape[1]
    s, _ = KD.feature_scale(C, T)
    g = torch.where(m["is_pos"], gp[:, None, None], gn[:, None, None])
    A = m["slope"] * m["w"] * m["conf"] * g
    srow = gp[:, None] * m["srow2"][0] + gn[:, None] * m["srow2"][1]
    scol = gp[:, None] * m["scol2"][0] + gn[:, None] * m["scol2"][1]
    dsim = 2 * A - m["r"] * srow[:, :, None] - m["c"] * scol[:, None, :]
    out = []
    for d, fb, La, Lb in ((dsim, m["x1"], L, S),
                          (dsim.transpose(1, 2), m["x0"], S, L)):
        ct, _, nch = KD.grad_plan(B, La, Lb, sms)
        n = ct * KD.GRAD_COLS
        parts = [_split_product(d[:, :, k * n:(k + 1) * n],
                                fb[:, k * n:(k + 1) * n])
                 for k in range(nch)]
        out.append((sum(parts) * s).bfloat16().float())
    return out


@pytest.mark.parametrize("sms", [132, 2])
@pytest.mark.parametrize("name", sorted(CASES))
def test_pass_model_matches_jax(name, sms):
    """The bf16 path's pass structure computes the JAX kernel's function;
    sms=2 cuts every grid into several chunks."""
    m = _forward_model(name, sms)
    gp, gn = _cot(m["x0"].shape[0])
    d0, d1 = _grad_model(m, gp, gn, sms)
    _assert_matches(m["pos"].numpy(), m["neg"].numpy(), d0.numpy(),
                    d1.numpy(), _jax(name))


@pytest.mark.parametrize("name", sorted(CASES))
def test_class_split_sums_give_b1(name):
    """gpos Srow_pos + gneg Srow_neg (and Scol alike) from the loss pass
    equal the JAX backward's first pass: Srow = sum_j A, Scol = sum_i A
    with A = focal'(conf) w conf g."""
    m = _forward_model(name, 2)
    B = m["x0"].shape[0]
    gp, gn = _cot(B)
    g = torch.where(m["is_pos"], gp[:, None, None], gn[:, None, None])
    A = (m["slope"] * m["w"] * m["conf"]).double() * g.double()
    for sums, ref in ((m["srow2"], A.sum(2)), (m["scol2"], A.sum(1))):
        got = gp[:, None].double() * sums[0] + gn[:, None].double() * sums[1]
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("B,La,Lb,sms", [(1, 4800, 4800, 132),
                                         (2, 4800, 4800, 132),
                                         (1, 4800, 1200, 132),
                                         (1, 1200, 4800, 132),
                                         (2, 333, 257, 3)])
def test_chunked_gradient_equals_unchunked(B, La, Lb, sms):
    """Partial products over grad_plan's chunks of side b, cut where the
    gradient grid cuts them (every ct * GRAD_COLS rows of the whole side)
    and added in ascending order, equal the product over all of side b;
    the chunks cover side b's tiles once each."""
    ct, nrt, nch = KD.grad_plan(B, La, Lb, sms)
    nct = math.ceil(Lb / KD.GRAD_COLS)
    assert nrt == math.ceil(La / KD.GRAD_ROWS)
    assert (nch - 1) * ct < nct <= nch * ct
    n = ct * KD.GRAD_COLS
    bounds = [(k * n, min((k + 1) * n, Lb)) for k in range(nch)]
    assert bounds[0][0] == 0 and bounds[-1][1] == Lb
    assert all(lo < hi for lo, hi in bounds)
    rng = np.random.RandomState(La + Lb)
    d = torch.from_numpy(rng.randn(B, 16, Lb).astype(np.float32))
    fb = torch.from_numpy(rng.randn(B, Lb, 32).astype(np.float32))
    parts = [d[:, :, lo:hi] @ fb[:, lo:hi] for lo, hi in bounds]
    full = (d.double() @ fb.double()).float()
    np.testing.assert_allclose(sum(parts).numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5 * float(full.abs().max()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hi_lo_split_product(seed):
    """dsim as bf16 hi + lo times bf16 features: within 2^-16 of the exact
    product, entry by entry, relative to sum |dsim| |f|."""
    rng = np.random.RandomState(seed)
    d = rng.randn(2, 32, 64) * np.exp(rng.randn(2, 32, 64) * 3)
    d = torch.from_numpy(d.astype(np.float32))
    fb = torch.from_numpy(rng.randn(2, 64, 48).astype(np.float32))
    fb = fb.bfloat16().float()
    exact = d.double() @ fb.double()
    got = _split_product(d, fb).double()
    bound = 2.0 ** -16 * (d.double().abs() @ fb.double().abs())
    assert ((got - exact).abs() <= bound).all()


@pytest.mark.parametrize("B,L,S", [(1, 4800, 4800), (2, 4800, 4800),
                                   (2, 4700, 4750), (1, 7, 7)])
def test_loss_plan_covers_the_columns(B, L, S):
    ct, nrt, nch = KD.loss_plan(B, L, S)
    nct = math.ceil(S / 128)
    assert nrt == math.ceil(L / 128)
    assert (nch - 1) * ct < nct <= nch * ct


def test_feature_scale_rounds_as_jax():
    s, sb = KD.feature_scale(256, 0.1)
    f = jnp.ones((1,), jnp.bfloat16) * s
    assert abs(s - 0.19764235) < 1e-7
    assert sb == float(f[0]) == float(np.float32(0.197265625))
