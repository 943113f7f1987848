"""PyTorch port: backbone, upsampling, packing and position encoding against
the JAX package, on the same seeded numpy inputs (CPU, float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.models.backbone import ResNetFPN_8_2 as JaxFPN
from loftr_tpu.models.position_encoding import (
    add_position_encoding as jax_add_pe)
from loftr_tpu.ops.interpolate import upsample2x_matmul
from loftr_tpu.ops.packing import pack_rows as jax_pack
from loftr_tpu_torch.models.backbone import ResNetFPN_8_2
from loftr_tpu_torch.models.position_encoding import add_position_encoding
from loftr_tpu_torch.ops.interpolate import upsample2x_align_corners
from loftr_tpu_torch.ops.packing import pack_rows, unpack_rows
from loftr_tpu_torch.utils.weights import state_dict_from_jax


def _backbone_pair(dims=(16, 24, 32), initial=16, seed=0):
    r = np.random.RandomState(seed)
    x = r.rand(2, 64, 48, 1).astype(np.float32)
    jm = JaxFPN(initial, dims)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    # non-trivial BN statistics, so the eval affine is exercised
    v = jax.tree.map(np.array, dict(v))
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["batch_stats"]):
        leaf[...] = (r.rand(*leaf.shape) + 0.5
                     if path[-1].key == "var" else r.randn(*leaf.shape) * .1)
    sd = state_dict_from_jax({"params": {"backbone": v["params"]},
                              "batch_stats": {"backbone": v["batch_stats"]}})
    tm = ResNetFPN_8_2(initial, dims)
    tm.load_state_dict({k[len("backbone."):]: t for k, t in sd.items()})
    return x, jm, v, tm.eval()


def test_backbone_matches_jax():
    x, jm, v, tm = _backbone_pair()
    want_c, want_f = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got_c, got_f = tm(torch.from_numpy(x))
    for got, want in ((got_c, want_c), (got_f, want_f)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max(), rtol=1e-4)


def test_backbone_bf16_tracks_jax():
    """bf16 rounds at other places in the two frameworks' conv kernels: a
    loose relative bar on the output scale."""
    x, jm, v, tm = _backbone_pair(seed=1)
    from loftr_tpu.models.backbone import ResNetFPN_8_2 as F
    jb = F(16, (16, 24, 32), dtype=jnp.bfloat16)
    want_c, _ = jb.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got_c, _ = tm(torch.from_numpy(x), torch.bfloat16)
    want = np.asarray(want_c, np.float32)
    err = np.abs(got_c.float().numpy() - want).mean() / np.abs(want).mean()
    assert got_c.dtype == torch.bfloat16
    assert err < 3e-2


@pytest.mark.parametrize("hw", [(4, 6), (1, 5), (7, 7)])
def test_upsample_align_corners(hw):
    r = np.random.RandomState(2)
    x = r.randn(2, hw[0], hw[1], 3).astype(np.float32)
    want = np.asarray(upsample2x_matmul(jnp.asarray(x)))
    got = upsample2x_align_corners(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-6)
    ref = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
        mode="bilinear", align_corners=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("mode", ["concat", "interleave"])
def test_packing_modes(mode):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = -a
    got = pack_rows(torch.from_numpy(a), torch.from_numpy(b), mode)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_pack(jnp.asarray(a), jnp.asarray(b),
                                         mode)))
    a2, b2 = unpack_rows(got, mode)
    np.testing.assert_array_equal(a2.numpy(), a)
    np.testing.assert_array_equal(b2.numpy(), b)


@pytest.mark.parametrize("temp_bug_fix", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_position_encoding_matches_jax(temp_bug_fix, dtype):
    r = np.random.RandomState(3)
    x = r.randn(2, 6, 8, 256).astype(np.float32)
    want = np.asarray(jax_add_pe(jnp.asarray(x, dtype), temp_bug_fix),
                      np.float32)
    got = add_position_encoding(torch.from_numpy(x).to(getattr(torch, dtype)),
                                temp_bug_fix)
    np.testing.assert_array_equal(got.float().numpy(), want)
