"""PyTorch port: kernel B's plain version against the JAX Pallas kernel (in
interpret mode) at ragged lengths, batch independence, and the bfloat16
launch plan's coverage of the column tiles."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.ops.pallas.dual_softmax import fused_dual_softmax_match as jfd
from loftr_tpu_torch.ops.kernels import dual_softmax as KB

C = 256  # the coarse width, the only one the bf16 kernel takes


def _bf16_round(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _pair(B, L, S, seed, masked):
    """bf16-rounded features with planted correspondences, and masks."""
    rng = np.random.RandomState(seed)
    f0 = rng.randn(B, L, C).astype(np.float32)
    f1 = rng.randn(B, S, C).astype(np.float32)
    n = max(1, min(L, S) // 4)
    for b in range(B):
        i, j = rng.permutation(L)[:n], rng.permutation(S)[:n]
        f1[b, j] = f0[b, i] + 0.1 * rng.randn(n, C)
    m0 = m1 = None
    if masked:
        m0 = rng.rand(B, L) > 0.2
        m1 = rng.rand(B, S) > 0.2
        m0[:, 0] = m1[:, 0] = True
    return _bf16_round(f0), _bf16_round(f1), m0, m1


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _near_tie_rows(f0, f1, m0, m1):
    """Rows whose two largest conf values lie within 1e-6 (relative)."""
    sim = torch.matmul(_t(f0), _t(f1).transpose(1, 2)) / (C * 0.1)
    if m0 is not None:
        sim = sim + (_t(m0).float()[:, :, None] * _t(m1).float()[:, None, :]
                     - 1.0) * 1e9
    conf = torch.softmax(sim, 2) * torch.softmax(sim, 1)
    if conf.shape[2] < 2:
        return np.zeros(conf.shape[:2], bool)
    top = conf.topk(2, dim=2).values
    return ((top[..., 0] - top[..., 1]) / top[..., 0].clamp_min(1e-30)
            < 1e-6).numpy()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,L,S", [(2, 333, 257), (1, 1, 7), (1, 200, 129)])
def test_plain_matches_jax_kernel_ragged(B, L, S, masked):
    """best_val / colconf at the bar of test_pallas_match.py:43 (rtol 1e-4,
    atol 1e-6), best_j exact outside near-ties.  The Pallas kernel pads
    rows and columns with masked entries, which changes the statistics of a
    masked row (column), so only unmasked rows and columns are compared
    (the epilogue never admits the others)."""
    f0, f1, m0, m1 = _pair(B, L, S, seed=L + S, masked=masked)
    gv, gj, gc = KB.fused_dual_softmax_match(_t(f0), _t(f1), 0.1, _t(m0),
                                             _t(m1))
    assert gv.dtype == torch.float32 and gj.dtype == torch.int32
    assert gv.shape == (B, L) and gc.shape == (B, S)
    near = _near_tie_rows(f0, f1, m0, m1)
    for b in range(B):
        bv, bj, cc = jfd(jnp.asarray(f0[b]), jnp.asarray(f1[b]), 0.1,
                         None if m0 is None else jnp.asarray(m0[b]),
                         None if m1 is None else jnp.asarray(m1[b]),
                         tile_l=128, interpret=True)
        rows = np.ones(L, bool) if m0 is None else m0[b]
        cols = np.ones(S, bool) if m1 is None else m1[b]
        np.testing.assert_allclose(gv[b].numpy()[rows], np.asarray(bv)[rows],
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(gc[b].numpy()[cols], np.asarray(cc)[cols],
                                   rtol=1e-4, atol=1e-6)
        keep = rows & ~near[b]
        np.testing.assert_array_equal(gj[b].numpy()[keep],
                                      np.asarray(bj)[keep])


def test_plain_pairs_are_independent_of_their_batch_neighbour():
    """A pair's three outputs do not change when the other pair of the
    batch changes (features and masks)."""
    f0, f1, m0, m1 = _pair(2, 150, 130, seed=7, masked=True)
    g0, g1, n0, n1 = _pair(2, 150, 130, seed=8, masked=True)
    f0b, f1b, m0b, m1b = f0.copy(), f1.copy(), m0.copy(), m1.copy()
    f0b[1], f1b[1], m0b[1], m1b[1] = g0[1], g1[1], n0[1], n1[1]
    a = KB.fused_dual_softmax_match(_t(f0), _t(f1), 0.1, _t(m0), _t(m1))
    b = KB.fused_dual_softmax_match(_t(f0b), _t(f1b), 0.1, _t(m0b), _t(m1b))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[0].numpy(), y[0].numpy())
    assert not np.array_equal(a[0][1].numpy(), b[0][1].numpy())


@pytest.mark.parametrize("B,L,S", [(1, 4800, 4800), (8, 4800, 4800),
                                   (2, 4700, 4750), (1, 7, 7),
                                   (1, 4800, 11025)])
def test_bf16_plan_covers_every_column_tile_once(B, L, S):
    """Blocks (row tile, chunk) of the bf16 launch: row tiles cover [0, L),
    and chunk c's column tiles [c*ct, min(nct, (c+1)*ct)) cover every
    column tile exactly once, none empty."""
    rows, cols, ct, nrt, nch = KB.bf16_plan(B, L, S, sms=132)
    assert (rows, cols) == (KB.BF16_ROWS, KB.BF16_COLS)
    assert nrt == math.ceil(L / rows) and (nrt - 1) * rows < L
    nct = math.ceil(S / cols)
    tiles = [t for c in range(nch)
             for t in range(c * ct, min(nct, (c + 1) * ct))]
    assert sorted(tiles) == list(range(nct)) and len(tiles) == nct
    assert all(c * ct < nct for c in range(nch))


@pytest.mark.parametrize("B", [1, 8])
def test_bf16_plan_picks_the_sweeps_winner(B):
    """At [B,4800,256], the main path's launches, the plan takes 13 column
    tiles a block in 3 chunks (114 blocks at B=1, 912 at B=8): the fastest
    chunk of tools/dual_softmax_tile_sweep.py at both batch sizes on an
    H100 (PERF.md, section 6)."""
    assert KB.bf16_plan(B, 4800, 4800, sms=132) == (128, 128, 13, 38, 3)


def test_wrapper_raises_off_cpu_and_cuda():
    """Neither CPU nor CUDA: no fallback, an error."""
    f = torch.empty((1, 7, C), device="meta")
    with pytest.raises(ValueError):
        KB.fused_dual_softmax_match(f, f, 0.1)
