"""PyTorch port: the window-attention kernel module's plain version against
the JAX package's Pallas kernel (interpret mode) and against linear
attention, and the ``fused_window_attn`` switch of the encoder layer.

Bars as tests/test_pallas_window_attn.py: float32 2e-4 (another summation
order), bfloat16 5e-2 (bf16 operands, float32 normaliser).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.ops.pallas.window_attention import \
    window_linear_attention as jax_window_attention
from loftr_tpu_torch.models.transformer import (LocalFeatureTransformer,
                                                LoFTREncoderLayer)
from loftr_tpu_torch.ops.attention import linear_attention
from loftr_tpu_torch.ops.kernels.window_attention import (
    window_attention_plain, window_linear_attention)
from loftr_tpu_torch.utils.weights import init_weights


def _qkv(nb, w2, c, seed):
    r = np.random.RandomState(seed)
    return [r.randn(nb, w2, c).astype(np.float32) for _ in range(3)]


def _linear(q, k, v, h):
    nb, w2, c = q.shape
    d = c // h
    out = linear_attention(q.reshape(nb, w2, h, d), k.reshape(nb, w2, h, d),
                           v.reshape(nb, w2, h, d))
    return out.reshape(nb, w2, c)


@pytest.mark.parametrize("nb,seed", [(96, 0), (24, 2)])
def test_plain_matches_pallas_kernel_f32(nb, seed):
    q, k, v = _qkv(nb, 25, 128, seed)
    want = np.asarray(jax_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), nheads=8,
        interpret=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = window_linear_attention(tq, tk, tv, nheads=8)    # CPU: plain
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), _linear(tq, tk, tv, 8).numpy(),
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(got, window_attention_plain(tq, tk, tv, 8))


def test_plain_matches_pallas_kernel_bf16():
    q, k, v = _qkv(64, 25, 128, 1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_window_attention(jq, jk, jv, nheads=8,
                                           interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = window_linear_attention(tq, tk, tv, nheads=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)
    # the same rounding points as the Pallas kernel: most entries agree to
    # the bf16 ulp
    assert np.mean(np.abs(got.float().numpy() - want)
                   <= 2 ** -7 * np.abs(want) + 1e-6) > 0.99
    ref = _linear(tq.float(), tk.float(), tv.float(), 8)
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("w2,c,h", [(9, 32, 2), (25, 16, 2)])
def test_plain_other_window_and_head_sizes(w2, c, h):
    q, k, v = (torch.from_numpy(x) for x in _qkv(10, w2, c, 3))
    np.testing.assert_allclose(
        window_linear_attention(q, k, v, nheads=h).numpy(),
        _linear(q, k, v, h).numpy(), rtol=2e-4, atol=2e-4)


def test_encoder_layer_switch_keeps_the_function():
    """fused_window_attn on: same parameters, same output to 2e-4 on
    windows; falls back to linear attention under masks or when x and
    source differ in shape."""
    plain = init_weights(LoFTREncoderLayer(32, 4), 3).eval()
    fused = LoFTREncoderLayer(32, 4, fused_window_attn=True).eval()
    fused.load_state_dict(plain.state_dict())
    r = np.random.RandomState(4)
    x = torch.from_numpy(r.randn(6, 25, 32).astype(np.float32))
    s = torch.from_numpy(r.randn(6, 25, 32).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(fused(x, s).numpy(), plain(x, s).numpy(),
                                   rtol=2e-4, atol=2e-4)
        assert not torch.equal(fused(x, s), plain(x, s))   # another route
        m = torch.ones(6, 25, dtype=torch.bool)
        assert torch.equal(fused(x, s, m, m), plain(x, s, m, m))
        assert torch.equal(fused(x, s[:, :20]), plain(x, s[:, :20]))


def test_transformer_switch_reaches_every_layer():
    tr = LocalFeatureTransformer(16, 2, ("self", "cross"),
                                 fused_window_attn=True)
    assert all(layer.fused_window_attn for layer in tr.layers)
    assert not any(layer.fused_window_attn for layer in
                   LocalFeatureTransformer(16, 2, ("self", "cross")).layers)
    ref = LocalFeatureTransformer(16, 2, ("self", "cross"))
    init_weights(ref, 5)
    tr.load_state_dict(ref.state_dict())
    r = np.random.RandomState(6)
    a = torch.from_numpy(r.randn(5, 25, 16).astype(np.float32))
    b = torch.from_numpy(r.randn(5, 25, 16).astype(np.float32))
    with torch.no_grad():
        g0, g1 = tr.eval()(a, b)
        w0, w1 = ref.eval()(a, b)
    np.testing.assert_allclose(g0.numpy(), w0.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(g1.numpy(), w1.numpy(), rtol=2e-4, atol=2e-4)
