"""PyTorch port: the pass structure of kernel E's bfloat16 path (the fused
Sinkhorn matcher) against the JAX Pallas kernel (interpret mode), at ragged
lengths, masked and unmasked, ``prefilter`` off and on.

The CUDA passes run only on the card (``chip_smoke.py`` phase 2).  Here a
plain model of their structure, written below, is held against
``loftr_tpu/ops/pallas/sinkhorn.py::fused_sinkhorn_match``: the streamed
side is cut into chunks by ``sinkhorn_plan``, the column pass is the row
pass with the operands swapped, partials combine in ascending chunk order
(the lowest index wins ties), and the column flags come from the last
column pass's maxima.  These model tests check the design (that this
pass structure computes the JAX kernel's function), not the CUDA code: of
the port they run only ``sinkhorn_plan``, and the kernel itself is held
to ``sinkhorn_plain`` on the card.  ``sinkhorn_plain`` is held against the
same JAX kernel at the same shapes.  Bars: those of tests/test_torch_sinkhorn.py (values
rtol 1e-4 atol 1e-6, ``best_j`` and the flags exact).
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.ops.pallas.sinkhorn import fused_sinkhorn_match as jax_fused
from loftr_tpu_torch.ops.kernels import sinkhorn as KE

C = 256          # the coarse width, the only one the bf16 kernel takes
B = 2
BIN_SCORE = 1.5
SHAPES = [(333, 257), (257, 333), (1, 7), (200, 129)]
NEG = -1e9


def _pair(L, S, masked):
    """bf16-rounded features of 4 a channel with planted correspondences
    (sim about 16 against N(0, 1)), so some rows and columns beat the
    dustbin and others do not; masks with a few leading cells masked."""
    rng = np.random.RandomState(L * 7 + S)
    f0 = (rng.randn(B, L, C) * 4).astype(np.float32)
    f1 = (rng.randn(B, S, C) * 4).astype(np.float32)
    n = max(1, min(L, S) * 3 // 10)
    for b in range(B):
        i, j = rng.permutation(L)[:n], rng.permutation(S)[:n]
        f1[b, j] = f0[b, i] + 0.4 * rng.randn(n, C)
    f0 = torch.from_numpy(f0).to(torch.bfloat16).float().numpy()
    f1 = torch.from_numpy(f1).to(torch.bfloat16).float().numpy()
    if not masked:
        return f0, f1, None, None
    m0, m1 = rng.rand(B, L) > 0.2, rng.rand(B, S) > 0.2
    m0[0, :3] = False
    return f0, f1, m0, m1


@functools.lru_cache(maxsize=None)
def _jax(L, S, masked, prefilter):
    """The JAX kernel pair by pair; no masks go in as all-ones masks (the
    same function, one trace fewer)."""
    f0, f1, m0, m1 = _pair(L, S, masked)
    if m0 is None:
        m0, m1 = np.ones((B, L), bool), np.ones((B, S), bool)
    outs = [jax_fused(jnp.asarray(f0[b]), jnp.asarray(f1[b]),
                      jnp.asarray(BIN_SCORE), 3, jnp.asarray(m0[b]),
                      jnp.asarray(m1[b]), interpret=True, prefilter=prefilter)
            for b in range(B)]
    return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(5)]


def _lse_pass(sim, bias, ct, n):
    """One row pass: per-chunk (max, sumexp) of sim + bias over the chunks
    of ct tiles of n streamed rows.  sim [B, nx, ny], bias [B, ny]."""
    ny = sim.shape[2]
    pm, ps = [], []
    for c0 in range(0, ny, ct * n):
        s = sim[:, :, c0:c0 + ct * n] + bias[:, None, c0:c0 + ct * n]
        m = s.amax(dim=2)
        pm.append(m)
        ps.append(torch.exp(s - m[..., None]).sum(dim=2))
    return pm, ps


def _lse_combine(pm, ps, extra=None):
    """Fixed-order log-sum-exp of the partials (and one extra term)."""
    m = pm[0]
    for x in pm[1:]:
        m = torch.maximum(m, x)
    if extra is not None:
        m = torch.maximum(m, extra)
    s = sum(st * torch.exp(mt - m) for mt, st in zip(pm, ps))
    if extra is not None:
        s = s + torch.exp(extra - m)
    return m, s


def _best_pass(sim, u, v, log_ls, ct, n, rows, keep0=None, keep1=None):
    """The best pass: conf formed once an element; per-chunk best value and
    first argmax combined in ascending chunk order (a later chunk wins only
    if larger), per-row-tile column max of conf, and the row maxima of
    sim + v."""
    S = sim.shape[2]
    best = torch.full(u.shape, -1.0)
    arg = torch.zeros(u.shape, dtype=torch.int64)
    rowlog = torch.full(u.shape, -math.inf)
    colconf = torch.full(v.shape, -1.0)
    s = sim + v[:, None, :]
    conf = torch.exp(s + (u + log_ls)[:, :, None])
    if keep0 is not None:
        conf = conf * keep0[:, :, None] * keep1[:, None, :]
    for c0 in range(0, S, ct * n):
        part = conf[:, :, c0:c0 + ct * n]
        bv, bj = part.max(dim=2)          # first maximum in the chunk
        win = bv > best
        best = torch.where(win, bv, best)
        arg = torch.where(win, bj + c0, arg)
        rowlog = torch.maximum(rowlog, s[:, :, c0:c0 + ct * n].amax(dim=2))
    for r0 in range(0, sim.shape[1], rows):
        colconf = torch.maximum(colconf, conf[:, r0:r0 + rows].amax(dim=1))
    return best, arg, colconf, rowlog


def _chunked_model(f0, f1, m0, m1, bin_score, iters, prefilter):
    """Kernel E's bf16 pass structure in plain float32 PyTorch."""
    f0, f1 = torch.from_numpy(f0), torch.from_numpy(f1)
    Bn, L, _ = f0.shape
    S = f1.shape[1]
    (R, N, ct, _, _), (Rc, Nc, ctc, _, _) = KE.sinkhorn_plan(Bn, L, S)
    sim = torch.matmul(f0, f1.transpose(1, 2)) * (1.0 / C)
    if m0 is not None:   # min((m0 - 1) 1e9, (m1 - 1) 1e9) of 0/1 masks
        b0 = (torch.from_numpy(m0).float() - 1) * -NEG
        b1 = (torch.from_numpy(m1).float() - 1) * -NEG
        sim = sim + torch.minimum(b0[:, :, None], b1[:, None, :])
    simT = sim.transpose(1, 2)
    alpha = torch.tensor(bin_score)
    log_ls = math.log(L + S)
    norm = -log_ls
    log_mu_bin, log_nu_bin = math.log(S) + norm, math.log(L) + norm
    u, v = torch.zeros(Bn, L), torch.zeros(Bn, S)
    ubin, vbin = torch.zeros(Bn), torch.zeros(Bn)

    def bin_update(x, other, log_marg):
        m, s = _lse_combine([x.amax(dim=1)], [torch.exp(
            x - x.amax(dim=1, keepdim=True)).sum(dim=1)], other)
        return log_marg - (alpha + m + torch.log(s))

    qm = None
    for _ in range(iters):
        ubin = bin_update(v, vbin, log_mu_bin)
        m, s = _lse_combine(*_lse_pass(sim, v, ct, N),
                            (alpha + vbin)[:, None])
        u = norm - (m + torch.log(s))
        qm, qs = _lse_pass(simT, u, ctc, Nc)     # sim^T: the swapped pass
        m, s = _lse_combine(qm, qs)
        col_lse = m + torch.log(torch.clamp(s, min=1e-38))
        v = norm - torch.logaddexp(col_lse, (alpha + ubin)[:, None])
        vbin = bin_update(u, ubin, log_nu_bin)
    if qm is None:     # no iteration: one column pass for the flags
        qm, _ = _lse_pass(simT, u, ctc, Nc)
    best, arg, colconf, rowlog = _best_pass(sim, u, v, log_ls, ct, N, R)
    collog = functools.reduce(torch.maximum, qm)
    pf0 = (alpha + vbin)[:, None] > rowlog
    pf1 = (alpha + ubin)[:, None] > collog
    if prefilter:
        best, arg, colconf, _ = _best_pass(sim, u, v, log_ls, ct, N, R,
                                           (~pf0).float(), (~pf1).float())
    return [x.numpy() for x in (best, arg.to(torch.int32), colconf, pf0,
                                pf1)]


def _assert_equal(got, want):
    bv, bj, cc, pf0, pf1 = got
    wbv, wbj, wcc, wpf0, wpf1 = want
    np.testing.assert_array_equal(pf0, wpf0)
    np.testing.assert_array_equal(pf1, wpf1)
    np.testing.assert_allclose(bv, wbv, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(cc, wcc, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(bj, wbj)


@pytest.mark.parametrize("prefilter", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L,S", SHAPES)
def test_chunked_pass_model_matches_jax_kernel(L, S, masked, prefilter):
    f0, f1, m0, m1 = _pair(L, S, masked)
    got = _chunked_model(f0, f1, m0, m1, BIN_SCORE, 3, prefilter)
    want = _jax(L, S, masked, prefilter)
    _assert_equal(got, want)
    if prefilter and L > 1:     # the filter fires, and some rows survive
        assert want[3].any() and not want[3].all()


@pytest.mark.parametrize("prefilter", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L,S", SHAPES)
def test_plain_matches_jax_kernel_ragged(L, S, masked, prefilter):
    f0, f1, m0, m1 = _pair(L, S, masked)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = KE.fused_sinkhorn_match(t(f0), t(f1), torch.tensor(BIN_SCORE), 3,
                                  t(m0), t(m1), prefilter=prefilter)
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.bool
    _assert_equal([x.numpy() for x in got], _jax(L, S, masked, prefilter))


def test_chunked_pass_model_without_iterations():
    """iters = 0: the launcher runs one column pass for the column flags."""
    f0, f1, m0, m1 = _pair(200, 129, True)
    got = _chunked_model(f0, f1, m0, m1, BIN_SCORE, 0, True)
    want = KE.sinkhorn_plain(torch.from_numpy(f0), torch.from_numpy(f1),
                             torch.tensor(BIN_SCORE), 0, torch.from_numpy(m0),
                             torch.from_numpy(m1), prefilter=True)
    _assert_equal(got, [x.numpy() for x in want])


@pytest.mark.parametrize("Bn,L,S", [(1, 4800, 4800), (8, 4800, 4800),
                                    (2, 4700, 4750), (1, 7, 7),
                                    (1, 4800, 1200)])
def test_plan_covers_every_tile_once_in_both_orientations(Bn, L, S):
    """Row and best passes: row tiles of f0 cover [0, L) and the chunks'
    f1 tiles cover every column tile exactly once, none empty; the column
    pass the same with L and S swapped."""
    for (rows, cols, ct, nrt, nch), (nx, ny) in zip(
            KE.sinkhorn_plan(Bn, L, S, sms=132), ((L, S), (S, L))):
        assert (rows, cols) == (128, 128)
        assert nrt == math.ceil(nx / rows) and (nrt - 1) * rows < nx
        nct = math.ceil(ny / cols)
        tiles = [t for c in range(nch)
                 for t in range(c * ct, min(nct, (c + 1) * ct))]
        assert sorted(tiles) == list(range(nct))
        assert all(c * ct < nct for c in range(nch))


def test_plan_at_the_main_path_launch():
    """[1,4800,256], match_pair's launch: 128 x 128 tiles, 38 row tiles x 3
    chunks of 13 tiles = 114 blocks (one wave on 132 SMs), both
    orientations."""
    row, col = KE.sinkhorn_plan(1, 4800, 4800, sms=132)
    assert row == col == (128, 128, 13, 38, 3)
    assert row[3] * row[4] == 114
