"""PyTorch port: a plain model of kernel G's bf16 band plan, held to the
wrapper's plain version and to the JAX Pallas kernel (interpret mode).

csrc/upsample.cu's bf16 path gives a block one (b, c) plane and a band of
64 output rows: it stages the input rows the band reads, forms each H-pass
value t once (rounded to bf16), and writes 8 adjacent outputs a thread in
16-byte stores, reading t at the clamped columns 4m - 1 .. 4m + 4 for the
outputs 8m .. 8m + 7; rows whose width is no multiple of 8 values take a
scalar path with the host's index tables.  The model repeats the plan on
seeded numpy inputs and checks what the kernel relies on: the staged rows
cover every tap of the band, the closed-form columns are the host's
wherever its weight is not 0, and the 16-byte stores and the scalar path
cover every output exactly once.

Bar: bit-equal.  Every product is of two bf16 values, so exact in float32,
and fma or not, matrix or gather, each sum of two rounds the same way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.ops.pallas.upsample import upsample2x_pallas
from loftr_tpu_torch.ops.interpolate import interp_taps
from loftr_tpu_torch.ops.kernels.upsample import upsample2x_plain

ROWS = 64                    # csrc/upsample.cu band::kRows
IN_ROWS = ROWS // 2 + 2      # band::kInRows


def bands(H):
    """(first output row, rows, first input row, input rows) a band."""
    ylo, yhi, _, _ = interp_taps(H, 2 * H)
    for o0 in range(0, 2 * H, ROWS):
        r = min(ROWS, 2 * H - o0)
        yield o0, r, int(ylo[o0]), int(yhi[o0 + r - 1] - ylo[o0] + 1)


def vector_columns(W):
    """The t columns the 16-byte path reads for each output (lo, hi)."""
    lo, hi = np.empty(2 * W, int), np.empty(2 * W, int)
    for m in range(W // 4):
        c = np.clip(4 * m - 1 + np.arange(6), 0, W - 1)
        for j in range(4):
            lo[8 * m + 2 * j], hi[8 * m + 2 * j] = c[j], c[j + 1]
            lo[8 * m + 2 * j + 1], hi[8 * m + 2 * j + 1] = c[j + 1], c[j + 2]
    return lo, hi


def _weights(n):
    lo, hi, wl, wh = interp_taps(n, 2 * n)
    r = [torch.from_numpy(w).bfloat16().double() for w in (wl, wh)]
    return torch.from_numpy(lo).long(), torch.from_numpy(hi).long(), *r


def _fma_bf16(w1, x1, w0, x0):
    """bf16(fmaf(w1, x1, w0 * x0)): the products are exact in float32."""
    return (w1 * x1 + w0 * x0).float().bfloat16().double()


def band_model(x):
    """x [B, C, H, W] bf16 -> (out, stores): the band plan, band by band;
    ``stores`` counts the writes to each output."""
    B, C, H, W = x.shape
    ylo, yhi, a0, a1 = _weights(H)
    xlo, xhi, b0, b1 = _weights(W)
    vec = W % 8 == 0
    if vec:
        vl, vh = (torch.from_numpy(c) for c in vector_columns(W))
    out = torch.zeros(B, C, 2 * H, 2 * W, dtype=torch.float64)
    stores = torch.zeros(2 * H, 2 * W, dtype=torch.int64)
    xd = x.double()
    for o0, r, y0, nin in bands(H):
        rows = xd[:, :, y0:y0 + nin]                     # staged input
        o = torch.arange(o0, o0 + r)
        t = _fma_bf16(a1[o, None], rows[:, :, yhi[o] - y0],
                      a0[o, None], rows[:, :, ylo[o] - y0])
        lo, hi = (vl, vh) if vec else (xlo, xhi)
        out[:, :, o0:o0 + r] = _fma_bf16(b1, t[..., hi], b0, t[..., lo])
        if vec:                                  # one store of 8 a chunk
            for m in range(W // 4):
                stores[o0:o0 + r, 8 * m:8 * m + 8] += 1
        else:                                    # one store a value
            stores[o0:o0 + r] += 1
    return out.bfloat16(), stores


@pytest.mark.parametrize("H", [1, 5, 60, 120])
@pytest.mark.parametrize("W", [1, 7, 80, 160])
def test_band_plan(W, H):
    ylo, yhi, _, _ = interp_taps(H, 2 * H)
    for o0, r, y0, nin in bands(H):
        assert nin <= IN_ROWS
        band = slice(o0, o0 + r)
        assert ylo[band].min() >= y0 and yhi[band].max() < y0 + nin
    x = torch.from_numpy(np.random.RandomState(W + H).randn(
        1, 2, H, W).astype(np.float32)).bfloat16()
    got, stores = band_model(x)
    assert bool((stores == 1).all())
    assert torch.equal(got, upsample2x_plain(x))


@pytest.mark.parametrize("W", [8, 16, 80, 160, 4096])
def test_vector_columns_are_the_taps(W):
    """Where the clamp at outputs 0 and 2W - 1 moves a column, the host's
    weight on it is 0, so the sum is the table form's."""
    lo, hi, wl, wh = interp_taps(W, 2 * W)
    vl, vh = vector_columns(W)
    wl, wh = (torch.from_numpy(w).bfloat16().float().numpy() != 0
              for w in (wl, wh))
    assert (vl[wl] == lo[wl]).all() and (vh[wh] == hi[wh]).all()
    assert sorted(np.flatnonzero((vl != lo) | (vh != hi))) == [0, 2 * W - 1]


@pytest.mark.parametrize("shape", [(1, 2, 6, 16), (2, 3, 9, 8)])
def test_band_model_matches_pallas_kernel(shape):
    x = torch.from_numpy(np.random.RandomState(7).randn(*shape).astype(
        np.float32)).bfloat16()
    want = np.asarray(upsample2x_pallas(
        jnp.asarray(x.permute(0, 2, 3, 1).float().numpy(), jnp.bfloat16),
        interpret=True), np.float32)
    got = band_model(x)[0].permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_array_equal(got, want)
