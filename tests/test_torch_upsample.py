"""PyTorch port: the upsample kernel module's plain version against the JAX
package's Pallas kernel (interpret mode) and matmul oracle, its tap tables,
and the backbone's module switch.

The JAX functions take NHWC, the port's NCHW: the test transposes.  Bar
1e-6 (tests/test_windows_interp.py:98-102).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from loftr_tpu.ops.interpolate import upsample2x_matmul
from loftr_tpu.ops.pallas.upsample import upsample2x_pallas
from loftr_tpu_torch.models import backbone as tb
from loftr_tpu_torch.ops.interpolate import (_interp_matrix, interp_taps,
                                             upsample2x_align_corners)
from loftr_tpu_torch.ops.kernels.upsample import upsample2x, upsample2x_plain
from loftr_tpu_torch.utils.weights import init_weights


def _taps_upsample(x):
    """The gather form the CUDA kernel computes, in PyTorch: 2 x 2 taps,
    weights rounded to the dtype, the H-pass result rounded to the dtype."""
    dt = x.dtype
    h, w = x.shape[-2:]
    ylo, yhi, alo, ahi = (torch.from_numpy(a) for a in interp_taps(h, 2 * h))
    xlo, xhi, blo, bhi = (torch.from_numpy(a) for a in interp_taps(w, 2 * w))
    rw = lambda t: t.to(dt).float()
    xf = x.float()
    t = (rw(alo)[:, None] * xf[..., ylo.long(), :]
         + rw(ahi)[:, None] * xf[..., yhi.long(), :]).to(dt).float()
    y = rw(blo) * t[..., xlo.long()] + rw(bhi) * t[..., xhi.long()]
    return y.to(dt)


@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (1, 12, 16, 256),
                                   (2, 6, 10, 196)])
def test_plain_matches_pallas_kernel_and_matmul(shape):
    r = np.random.RandomState(0)
    x = r.randn(*shape).astype(np.float32)                      # NHWC
    want_k = np.asarray(upsample2x_pallas(jnp.asarray(x), interpret=True))
    want_m = np.asarray(upsample2x_matmul(jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()   # NCHW
    got = upsample2x(xt)                                        # CPU: plain
    assert torch.equal(got, upsample2x_plain(xt))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want_k, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_m, rtol=1e-6, atol=1e-6)
    lib = F.interpolate(xt, scale_factor=2, mode="bilinear",
                        align_corners=True)
    np.testing.assert_allclose(got, lib.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2 ** -7)])
def test_gather_form_equals_plain(dtype, tol):
    """The 2 x 2-tap form of csrc/upsample.cu against the two-matmul plain
    version: float rounding in float32, one ulp in bfloat16."""
    r = np.random.RandomState(1)
    x = torch.from_numpy(r.randn(2, 5, 6, 10).astype(np.float32)).to(dtype)
    got = _taps_upsample(x).float()
    want = upsample2x_align_corners(x).float()
    assert got.shape == (2, 5, 12, 20)
    assert bool(((got - want).abs() <= tol * want.abs() + 1e-6).all())
    if dtype == torch.bfloat16:
        assert float((got == want).float().mean()) > 0.99


@pytest.mark.parametrize("n", [1, 2, 7, 60])
def test_taps_are_the_matrix_rows(n):
    lo, hi, w_lo, w_hi = interp_taps(n, 2 * n)
    m = _interp_matrix(n, 2 * n)
    assert m.shape == (2 * n, n) and m.dtype == np.float32
    rebuilt = np.zeros_like(m)
    np.add.at(rebuilt, (np.arange(2 * n), hi), w_hi)
    np.add.at(rebuilt, (np.arange(2 * n), lo), w_lo)
    np.testing.assert_array_equal(rebuilt, m)
    np.testing.assert_allclose(m.sum(axis=1), 1.0, atol=1e-6)
    assert (np.count_nonzero(m, axis=1) <= 2).all()


def test_backbone_switch_keeps_the_function(monkeypatch):
    """_USE_PALLAS_UPSAMPLE on: both x2 sites go through the kernel module
    at inference (its plain version on the CPU: the same maps); training
    keeps the differentiable form."""
    calls = []
    import loftr_tpu_torch.ops.kernels.upsample as ku
    real = ku.upsample2x
    monkeypatch.setattr(ku, "upsample2x",
                        lambda x: calls.append(tuple(x.shape)) or real(x))
    net = init_weights(tb.ResNetFPN_8_2(16, (16, 24, 32)), 2).eval()
    x = torch.from_numpy(
        np.random.RandomState(3).rand(1, 32, 48, 1).astype(np.float32))
    assert tb._USE_PALLAS_UPSAMPLE is False
    with torch.no_grad():
        want = net(x)
        assert calls == []
        monkeypatch.setattr(tb, "_USE_PALLAS_UPSAMPLE", True)
        got = net(x)
    assert calls == [(1, 32, 4, 6), (1, 24, 8, 12)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    calls.clear()
    net.train()(x)[0].sum().backward()           # training: plain, with grad
    assert calls == []
    assert net.conv1.weight.grad is not None
