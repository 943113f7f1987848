"""PyTorch port: linear attention, the encoder layer and the coarse-layer
kernel module's plain version against the JAX package (the Pallas kernel in
interpret mode), on the same seeded numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.models.fused_coarse import FusedCoarseTransformer
from loftr_tpu.models.transformer import (LocalFeatureTransformer as JaxLFT,
                                          LoFTREncoderLayer as JaxLayer)
from loftr_tpu.ops.attention import linear_attention as jax_linear_attention
from loftr_tpu.ops.pallas.coarse_layer import fused_coarse_layer as jax_fcl
from loftr_tpu.ops.pallas.fine_stage import EncoderWeights as JaxW
from loftr_tpu_torch.models.fused_coarse import fused_coarse_forward
from loftr_tpu_torch.models.transformer import LocalFeatureTransformer
from loftr_tpu_torch.ops.attention import linear_attention
from loftr_tpu_torch.ops.kernels.coarse_layer import (TILE_S,
                                                      coarse_layer_plain,
                                                      fused_coarse_layer)
from loftr_tpu_torch.ops.kernels.fine_stage import EncoderWeights
from loftr_tpu_torch.utils.weights import state_dict_from_jax

B, L, S, C, H = 2, 96, 80, 256, 8   # full coarse width, short sequences
S_RAGGED = 100                      # no multiple of the source tile


def _rand(seed, shape):
    return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(
        np.float32)


def _masks(seed):
    r = np.random.RandomState(seed)
    return r.rand(B, L) > 0.3, r.rand(B, S) > 0.3


def _jax_layer(seed, x, src):
    layer = JaxLayer(C, H, "linear")
    v = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(src))
    return layer, jax.tree.map(np.asarray, dict(v))


def _weights(p):
    """JAX layer params -> (JAX EncoderWeights, port EncoderWeights)."""
    leaves = dict(q=p["q_proj"]["kernel"], k=p["k_proj"]["kernel"],
                  v=p["v_proj"]["kernel"], merge=p["merge"]["kernel"],
                  ln1_s=p["norm1"]["scale"], ln1_b=p["norm1"]["bias"],
                  mlp0=p["mlp_0"]["kernel"], mlp2=p["mlp_2"]["kernel"],
                  ln2_s=p["norm2"]["scale"], ln2_b=p["norm2"]["bias"])
    return (JaxW(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            EncoderWeights(**{k: torch.from_numpy(np.array(v))
                              for k, v in leaves.items()}))


def _port_stack(prefix, params, names, d=C, h=H):
    sd = state_dict_from_jax({"params": {prefix: params}})
    tr = LocalFeatureTransformer(d, h, names)
    tr.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()})
    return tr


@pytest.mark.parametrize("masked", [False, True])
def test_linear_attention_matches_jax(masked):
    q, k, v = (_rand(i, (B, L if i == 0 else S, H, 32)) for i in range(3))
    qm, km = _masks(4) if masked else (None, None)
    want = jax_linear_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if qm is None else jnp.asarray(qm),
        None if km is None else jnp.asarray(km))
    got = linear_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if qm is None else torch.from_numpy(qm),
        None if km is None else torch.from_numpy(km))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_layer_matches_jax(masked):
    x, src = _rand(5, (B, L, C)), _rand(6, (B, S, C))
    layer, v = _jax_layer(0, x, src)
    xm, sm = _masks(7) if masked else (None, None)
    want = layer.apply(v, jnp.asarray(x), jnp.asarray(src),
                       None if xm is None else jnp.asarray(xm),
                       None if sm is None else jnp.asarray(sm))
    tr = _port_stack("loftr_coarse", {"layer_0": v["params"]}, ("self",))
    with torch.no_grad():
        got = tr.layers[0](torch.from_numpy(x), torch.from_numpy(src),
                           None if xm is None else torch.from_numpy(xm),
                           None if sm is None else torch.from_numpy(sm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_kernel_plain_matches_jax_kernel(masked):
    """Plain version of kernel A against the Pallas kernel (interpret mode),
    at the bar of test_coarse_layer_fused.py:42."""
    x, src = _rand(8, (B, L, C)), _rand(9, (B, S, C))
    _, v = _jax_layer(1, x, src)
    jw, tw = _weights(v["params"])
    xm, sm = _masks(10) if masked else (None, None)
    want = jax_fcl(jnp.asarray(x), jnp.asarray(src), jw,
                   None if xm is None else jnp.asarray(xm),
                   None if sm is None else jnp.asarray(sm), nheads=H,
                   tile=TILE_S)
    got = fused_coarse_layer(torch.from_numpy(x), torch.from_numpy(src), tw,
                             None if xm is None else torch.from_numpy(xm),
                             None if sm is None else torch.from_numpy(sm),
                             nheads=H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


def test_kernel_plain_bf16_rounds_like_jax_kernel():
    """bf16: the plain version rounds where the Pallas kernel rounds; the
    sums run in another order, so a few elements may differ by one ulp."""
    x, src = _rand(11, (B, L, C)), _rand(12, (B, S, C))
    _, v = _jax_layer(2, x, src)
    jw, tw = _weights(v["params"])
    want = np.asarray(jax_fcl(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(src, jnp.bfloat16), jw, nheads=H,
                              tile=TILE_S), np.float32)
    got = coarse_layer_plain(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(src).bfloat16(), tw,
                             nheads=H).float().numpy()
    d = np.abs(got - want)
    assert d.mean() < 1e-3 and d.max() <= 0.125


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_plain_matches_jax_kernel_ragged_source(dtype):
    """A source length that is no multiple of the kernel's source tile
    (S = 100 against TILE_S), masked, at C = 64: the plain version against
    the Pallas kernel run at that tile.  float32 at the bar of
    test_coarse_layer_fused.py:42; bfloat16 as the test above."""
    assert S_RAGGED % TILE_S
    c, h, b, lx = 64, 8, 2, 40
    r = np.random.RandomState(16)
    x = (r.randn(b, lx, c) * 0.5).astype(np.float32)
    src = (r.randn(b, S_RAGGED, c) * 0.5).astype(np.float32)
    xm, sm = r.rand(b, lx) > 0.2, r.rand(b, S_RAGGED) > 0.2
    layer = JaxLayer(c, h, "linear")
    v = jax.tree.map(np.asarray, dict(layer.init(
        jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(src))))
    jw, tw = _weights(v["params"])
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax_fcl(jnp.asarray(x, jdt), jnp.asarray(src, jdt), jw,
                              jnp.asarray(xm), jnp.asarray(sm), nheads=h,
                              tile=TILE_S), np.float32)
    got = fused_coarse_layer(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(src).to(tdt), tw,
                             torch.from_numpy(xm), torch.from_numpy(sm),
                             nheads=h).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    else:
        d = np.abs(got - want)
        assert d.mean() < 1e-3 and d.max() <= 0.125


def test_stack_matches_jax_fused_and_plain():
    """The port's kernel-module stack and plain stack against the JAX fused
    stack, at the bar of test_coarse_layer_fused.py:70."""
    names = ("self", "cross") * 2
    x, src = _rand(13, (B, L, C)), _rand(14, (B, L, C))
    tr_j = JaxLFT(C, H, names, "linear")
    v = jax.tree.map(np.asarray, dict(tr_j.init(jax.random.PRNGKey(3),
                                                jnp.asarray(x),
                                                jnp.asarray(src))))
    want0, want1 = FusedCoarseTransformer(C, H, names, tile=32).apply(
        v, jnp.asarray(x), jnp.asarray(src))
    tr = _port_stack("loftr_coarse", v["params"], names)
    with torch.no_grad():
        got_k = fused_coarse_forward(tr, torch.from_numpy(x),
                                     torch.from_numpy(src))
        got_p = tr(torch.from_numpy(x), torch.from_numpy(src))
    for got in (got_k, got_p):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want0),
                                   atol=5e-4, rtol=5e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want1),
                                   atol=5e-4, rtol=5e-4)


def test_wrapper_uses_plain_version_on_cpu():
    x = torch.from_numpy(_rand(15, (1, 8, C)))
    w = EncoderWeights(*[torch.zeros(s) for s in
                         [(C, C)] * 4 + [(C,), (C,), (2 * C, 2 * C),
                                         (2 * C, C), (C,), (C,)]])
    before = fused_coarse_layer.launches
    out = fused_coarse_layer(x, x, w, nheads=H)
    assert fused_coarse_layer.launches == before  # no kernel on the CPU
    torch.testing.assert_close(out, x)  # zero weights: y = LN(0) = 0
