"""PyTorch port: the upsample kernel module's plain version against the JAX
package's Pallas kernel (interpret mode) and matmul oracle, its tap tables,
the FPN merge's wrapper (plain version, refusals) and the backbone's
dispatch of its two merges.

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
from loftr_tpu_torch.ops.kernels import upsample as ku
from loftr_tpu_torch.ops.kernels.upsample import (upsample2x, upsample2x_add,
                                                  upsample2x_add_plain,
                                                  upsample2x_plain)
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


def _merge_model(lateral, coarse):
    """The NHWC merge kernel's arithmetic in PyTorch, on channels-last
    arrays: per output pixel its 2 x 2 taps of the coarser map, the H pass
    and the W pass each rounded to the dtype, then the rounded sum."""
    dt = lateral.dtype
    h, w = coarse.shape[-2:]
    ylo, yhi, alo, ahi = (torch.from_numpy(a) for a in interp_taps(h, 2 * h))
    xlo, xhi, blo, bhi = (torch.from_numpy(a) for a in interp_taps(w, 2 * w))
    rw = lambda t: t.to(dt).float()
    x = coarse.permute(0, 2, 3, 1).float()                      # [B, H, W, C]
    a0, a1 = rw(alo)[:, None, None], rw(ahi)[:, None, None]
    b0, b1 = rw(blo)[:, None], rw(bhi)[:, None]

    def hpass(cols):                                # [B, 2H, 2W, C]
        v0 = x[:, ylo.long()][:, :, cols.long()]
        v1 = x[:, yhi.long()][:, :, cols.long()]
        return (a0 * v0 + a1 * v1).to(dt).float()
    up = (b0 * hpass(xlo) + b1 * hpass(xhi)).to(dt).float()
    out = lateral.permute(0, 2, 3, 1).float() + up
    return out.to(dt).permute(0, 3, 1, 2)


# the backbones' merge sites scaled down ([B, C, H, W] of the coarser map),
# then ragged shapes: H = 1, W = 1, both, odd sizes, C not a multiple of 8
MERGE_SHAPES = [(4, 64, 6, 8), (4, 64, 12, 16), (2, 64, 7, 7), (2, 32, 14, 14),
                (1, 16, 1, 9), (2, 8, 5, 1), (1, 24, 1, 1), (2, 12, 7, 5),
                (1, 3, 5, 7)]


@pytest.mark.parametrize("shape", MERGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_merge_plain_is_the_backbone_expression(shape, dtype, layout):
    """On the CPU the wrapper is ``lateral + upsample2x_align_corners(
    coarse)`` bit for bit, in either layout; in bfloat16 that is also the
    kernel's rounding, modelled on channels-last arrays."""
    b, c, h, w = shape
    r = np.random.RandomState(sum(shape))
    coarse = torch.from_numpy(r.randn(*shape).astype(np.float32)).to(dtype)
    lateral = torch.from_numpy(
        r.randn(b, c, 2 * h, 2 * w).astype(np.float32)).to(dtype)
    if layout == "channels_last":
        coarse = coarse.contiguous(memory_format=torch.channels_last)
        lateral = lateral.contiguous(memory_format=torch.channels_last)
    want = lateral + upsample2x_align_corners(coarse)
    got = upsample2x_add(lateral, coarse)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(upsample2x_add_plain(lateral, coarse), want)
    model = _merge_model(lateral, coarse)
    if dtype == torch.bfloat16:
        assert torch.equal(model, want)
    else:                           # float32: two-term sums, fused or not
        torch.testing.assert_close(model, want, rtol=1e-6, atol=1e-6)


def test_merge_refuses_gradients_and_mismatched_shapes():
    x = torch.zeros(1, 8, 3, 4)
    lat = torch.zeros(1, 8, 6, 8)
    with pytest.raises(RuntimeError, match="inference only"):
        upsample2x_add(lat, x.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="inference only"):
        upsample2x_add(lat.clone().requires_grad_(), x)
    with torch.no_grad():                       # no graph: computed
        upsample2x_add(lat.clone().requires_grad_(), x)
    for bad in (torch.zeros(1, 8, 6, 7), torch.zeros(1, 4, 6, 8),
                torch.zeros(2, 8, 6, 8), torch.zeros(8, 6, 8)):
        with pytest.raises(ValueError):
            upsample2x_add(bad, x)
    with pytest.raises(ValueError):
        upsample2x_add(lat, torch.zeros(8, 3, 4))


def _merge_dispatch(monkeypatch, net, sites, channels_last=True):
    """An eval forward without a graph sends both merge sites through the
    upsample-add wrapper (with channels-last maps where the backbone keeps
    them), and its maps equal those of the plain merge; training with a
    gradient never calls it."""
    calls = []
    real = ku.upsample2x_add

    def spy(lateral, coarse):
        cl = torch.channels_last
        calls.append((tuple(coarse.shape),
                      lateral.is_contiguous(memory_format=cl)
                      and coarse.is_contiguous(memory_format=cl)))
        return real(lateral, coarse)
    monkeypatch.setattr(ku, "upsample2x_add", spy)
    net = init_weights(net, 2).eval()
    x = torch.from_numpy(
        np.random.RandomState(3).rand(1, 32, 48, 1).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        calls.clear()
        with torch.no_grad():
            got = net(x, dt)
        assert [shape for shape, _ in calls] == sites
        assert all(cl for _, cl in calls) or not channels_last
        with monkeypatch.context() as m:
            m.setattr(tb, "_merge", lambda conv, x, c, train:
                      tb.apply_conv(conv, x) + upsample2x_align_corners(c))
            with torch.no_grad():
                want = net(x, dt)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    calls.clear()
    net(x)[0].sum().backward()                   # eval with a graph: plain
    assert calls == []
    net.zero_grad()
    net.train()(x)[0].sum().backward()           # training: plain, with grad
    assert calls == []
    assert net.conv1.weight.grad is not None


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_backbone_switch_keeps_the_function(monkeypatch, norm):
    """The backbone's choice of x2 merge (which replaced the module switch
    ``_USE_PALLAS_UPSAMPLE``) at ResNetFPN_8_2's two sites; a ``group``
    backbone's merges take the wrapper too, whatever layout its GroupNorm
    leaves (on the card ``_merge`` makes the maps channels-last)."""
    _merge_dispatch(monkeypatch, tb.ResNetFPN_8_2(16, (16, 24, 32), norm=norm),
                    [(1, 32, 4, 6), (1, 24, 8, 12)],
                    channels_last=norm == "batch")


def test_backbone_16_4_merge_dispatch(monkeypatch):
    """The same at ResNetFPN_16_4's two sites."""
    _merge_dispatch(monkeypatch, tb.ResNetFPN_16_4(16, (16, 24, 32, 40)),
                    [(1, 40, 2, 3), (1, 32, 4, 6)])

