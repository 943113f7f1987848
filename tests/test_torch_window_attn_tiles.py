"""PyTorch port: a plain model of kernel F's bf16 design, held to the
wrapper's plain version and to the JAX Pallas kernel (interpret mode).

csrc/window_attention.cu computes the fine stage's windows (25 x 128, 8
heads of 16) on mma.sync: one warp a (window, head), each operand padded
from 25 to 32 rows in shared memory, phi applied once to the tile, the
scores' row sums from the float accumulators, the scores rounded to bf16
and multiplied by the padded V.  Blocks walk the windows grid-stride
through a 2-stage ring a warp.  The model below repeats that on seeded
numpy inputs: the padded 32 x 32 tile form, the stale contents a ring
stage can hold in its padding, and the schedule of windows over blocks and
stages.

Bars: the model and the plain version round at the same places and sum in
other orders, so they agree to one bf16 ulp plus what a flipped score
rounding moves (chip_smoke.py's tolF); against the Pallas kernel the bars
of tests/test_torch_window_attn.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.ops.pallas.window_attention import \
    window_linear_attention as jax_window_attention
from loftr_tpu_torch.ops.kernels.fine_stage import phi
from loftr_tpu_torch.ops.kernels.window_attention import \
    window_attention_plain

W2, C, HEADS, D = 25, 128, 8, 16     # csrc/window_attention.cu fine::
ROWS, STAGES = 32, 2                 # kRows, kStages
BLOCKS_PER_SM, SMS = 3, 132          # kMinBlocks: the wave on the H100


def _qkv(nb, seed):
    r = np.random.RandomState(seed)
    return [torch.from_numpy(r.randn(nb, W2, C).astype(np.float32))
            .bfloat16() for _ in range(3)]


def _tiles(x, stale):
    """[NB, 25, C] -> [NB, heads, 32, 16] float, rows 25-31 = stale."""
    t = torch.full((x.shape[0], ROWS, C), stale, dtype=torch.float32)
    t[:, :W2] = x.float()
    return t.reshape(-1, ROWS, HEADS, D).permute(0, 2, 1, 3)


def tile_model(q, k, v, eps=1e-6, stale=0.0):
    """The kernel's padded tile form.  The ring copies rows 0-24; rows 25-31
    of a stage hold ``stale`` in Q (never stored) and zeros in K and V (set
    once; neither the ring nor phi writes them)."""
    Q = _tiles(q, 0.0)
    Q[:, :, :W2] = phi(Q[:, :, :W2]).bfloat16().float()
    Q[:, :, W2:] = stale
    K = _tiles(k, 0.0)
    K[:, :, :W2] = phi(K[:, :, :W2]).bfloat16().float()   # pad stays 0
    V = _tiles(v, 0.0)
    s = Q @ K.transpose(-1, -2)                  # [NB, h, 32, 32] float
    z = 1.0 / (s.sum(-1) + eps)                  # padded columns add 0
    o = (s.bfloat16().float() @ V) * z[..., None]
    return (o[:, :, :W2].permute(0, 2, 1, 3).reshape(-1, W2, C)
            .bfloat16())


def _close(got, want):
    d = (got.float() - want.float()).abs()
    assert bool((d <= 2e-3 + 2 ** -7 * want.float().abs()).all())
    return float((d == 0).float().mean())


@pytest.mark.parametrize("nb,seed", [(8, 0), (33, 1)])
def test_tile_model_matches_plain(nb, seed):
    q, k, v = _qkv(nb, seed)
    assert _close(tile_model(q, k, v), window_attention_plain(q, k, v,
                                                              HEADS)) > 0.99


def test_tile_model_matches_pallas_kernel():
    q, k, v = _qkv(16, 2)
    want = np.asarray(jax_window_attention(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        nheads=HEADS, interpret=True), np.float32)
    got = tile_model(q, k, v).float().numpy()
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    assert np.mean(np.abs(got - want) <= 2 ** -7 * np.abs(want) + 1e-6) \
        > 0.99


def test_padding_traps():
    """phi(0) = 1: padded K rows taken through phi add 7 |Q_h|_1 to every
    row sum; stale NaN in the Q padding never reaches the output, in the V
    padding it would (0 * NaN is NaN)."""
    q, k, v = _qkv(4, 3)
    want = tile_model(q, k, v)
    got = tile_model(q, k, v, stale=float("nan"))
    assert torch.isfinite(got.float()).all() and torch.equal(got, want)
    Q = _tiles(q, 0.0)
    Q[:, :, :W2] = phi(Q[:, :, :W2]).bfloat16().float()
    K = _tiles(k, 0.0)
    Kphi = phi(K).bfloat16().float()             # the trap: phi on the pad
    gain = (Q @ Kphi.transpose(-1, -2)).sum(-1) - \
        (Q @ torch.where(torch.arange(ROWS)[:, None] < W2, Kphi, 0.0)
         .transpose(-1, -2)).sum(-1)
    np.testing.assert_allclose(gain[:, :, :W2].numpy(),
                               (ROWS - W2) * Q[:, :, :W2].abs().sum(-1)
                               .numpy(), rtol=1e-5)
    V = _tiles(v, float("nan"))
    s = Q @ torch.where(torch.arange(ROWS)[:, None] < W2, Kphi, 0.0) \
        .transpose(-1, -2)
    assert torch.isnan(s.bfloat16().float() @ V).all()


def schedule(nb, grid_max, nst=STAGES):
    """The bf16 launcher and kernel's walk: ``grid = min(NB, grid_max)``
    blocks; block b takes windows b, b + grid, ... (n of them); window i of
    a block goes through ring stage i % nst, issued nst - 1 windows ahead
    (the prologue issues windows 0 .. nst - 2, iteration i issues
    i + nst - 1 after waiting for window i).  Yields (block, i, window);
    asserts on the ring."""
    grid = min(nb, grid_max)
    for b in range(grid):
        n = (nb - 1 - b) // grid + 1
        stage = [None] * nst
        for s in range(min(nst - 1, n)):
            stage[s] = b + s * grid
        for i in range(n):
            assert stage[i % nst] == b + i * grid    # landed and right
            nx = i + nst - 1
            if nx < n:
                # the overwritten stage held window i - 1, already done
                assert (nx % nst) != (i % nst)
                assert stage[nx % nst] in (None, b + (i - 1) * grid)
                stage[nx % nst] = b + nx * grid
            yield b, i, b + i * grid


@pytest.mark.parametrize("nb", [1, 7, 1021])
@pytest.mark.parametrize("grid_max,nst", [(BLOCKS_PER_SM * SMS, STAGES),
                                          (4, STAGES), (4, 3)])
def test_schedule_covers_each_window_once(nb, grid_max, nst):
    """Ragged window counts through the grid-stride walk and the ring (the
    launch's depth, and the 3 stages tools/window_upsample_sweep.py also
    times) give the straight loop over the windows."""
    order = [w for _, _, w in schedule(nb, grid_max, nst)]
    assert sorted(order) == list(range(nb))
    q, k, v = _qkv(nb, nb)
    idx = torch.tensor(order)
    out = torch.empty_like(q)
    out[idx] = tile_model(q[idx], k[idx], v[idx])
    assert _close(out, window_attention_plain(q, k, v, HEADS)) > 0.99
