"""PyTorch port: kernel C's plain version at window-pair counts that no
pairs-per-block count of the kernel divides, against the JAX Pallas kernel
(interpret mode) on its own block-halving path, and each pair's result
independent of the nonzero pairs packed beside it.  Full fine width (C=128,
8 heads, d=16 as on the main path); the bars of tests/test_torch_fine.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.ops.pallas.fine_stage import EncoderWeights as JaxWeights
from loftr_tpu.ops.pallas.fine_stage import fused_fine_stage as jax_kernel
from loftr_tpu_torch.ops.kernels.fine_stage import (EncoderWeights,
                                                    fine_stage_plain)

W2, C, H = 25, 128, 8
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _layers(seed):
    """Two encoder layers' weights as float32 numpy arrays."""
    r = np.random.RandomState(seed)

    def mat(i, o):
        return (r.randn(i, o) / np.sqrt(i)).astype(np.float32)

    def vec(base):
        return (base + 0.1 * r.randn(C)).astype(np.float32)
    return [dict(q=mat(C, C), k=mat(C, C), v=mat(C, C), merge=mat(C, C),
                 ln1_s=vec(1.0), ln1_b=vec(0.0), mlp0=mat(2 * C, 2 * C),
                 mlp2=mat(2 * C, C), ln2_s=vec(1.0), ln2_b=vec(0.0))
            for _ in range(2)]


def _windows(seed, nb):
    r = np.random.RandomState(seed)
    return ((r.randn(nb, W2, C) * 0.5).astype(np.float32),
            (r.randn(nb, W2, C) * 0.5).astype(np.float32))


def _jax(win0, win1, layers, dt, block_windows):
    jl = [JaxWeights(**{k: jnp.asarray(v) for k, v in l.items()})
          for l in layers]
    return np.asarray(jax_kernel(
        jnp.asarray(win0, dt), jnp.asarray(win1, dt), jl[0], jl[1], H,
        block_windows=block_windows, interpret=True))


def _port(win0, win1, layers, dt):
    tl = [EncoderWeights(**{k: torch.from_numpy(v) for k, v in l.items()})
          for l in layers]
    with torch.no_grad():
        return fine_stage_plain(torch.from_numpy(win0).to(dt),
                                torch.from_numpy(win1).to(dt), tl[0], tl[1],
                                H).numpy()


def _close(got, want, dtype):
    if dtype == "float32":     # test_fine_stage_fused.py:65
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    else:                      # window coordinates, single rounding flips
        assert np.abs(got - want).max() < 5e-2


@pytest.mark.parametrize("nb", [6, 7])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_kernel_at_ragged_counts(dtype, nb):
    """block_windows=4 divides neither count: the JAX kernel halves its
    block to 2 pairs (NB=6) or 1 (NB=7), the reference for the CUDA
    kernel's ragged last block."""
    jdt, tdt = DTYPES[dtype]
    win0, win1 = _windows(10 + nb, nb)
    layers = _layers(20 + nb)
    want = _jax(win0, win1, layers, jdt, block_windows=4)
    got = _port(win0, win1, layers, tdt)
    assert got.shape == (nb, 3) and np.isfinite(got).all()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pair_ignores_the_pairs_packed_beside_it(dtype):
    """Pair 1 sits between pairs 0 and 2 in one 3-pair block of the JAX
    kernel.  New nonzero values in every other pair leave its result as it
    was, in the JAX kernel and in the port, and the port holds the JAX
    kernel on it."""
    jdt, tdt = DTYPES[dtype]
    nb = 6
    win0, win1 = _windows(30, nb)
    layers = _layers(31)
    other0, other1 = _windows(32, nb)
    keep = np.arange(nb) == 1
    new0 = np.where(keep[:, None, None], win0, other0)
    new1 = np.where(keep[:, None, None], win1, other1)
    j_base = _jax(win0, win1, layers, jdt, block_windows=3)
    j_new = _jax(new0, new1, layers, jdt, block_windows=3)
    p_base = _port(win0, win1, layers, tdt)
    p_new = _port(new0, new1, layers, tdt)
    for base, new in ((j_base, j_new), (p_base, p_new)):
        np.testing.assert_allclose(new[1], base[1], atol=1e-6, rtol=0)
        assert not np.allclose(new[~keep], base[~keep], atol=1e-6)
    _close(p_new, j_new, dtype)
