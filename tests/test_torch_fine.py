"""PyTorch port: fine windows, fine matching and the fine-stage kernel
module's plain version against the JAX package (the Pallas kernel in
interpret mode), on the same seeded numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.models.fused_fine import FusedFineStage
from loftr_tpu.models.transformer import LocalFeatureTransformer as JaxLFT
from loftr_tpu.ops.fine_match import fine_kpts as jax_fine_kpts
from loftr_tpu.ops.fine_match import fine_match as jax_fine_match
from loftr_tpu.ops.windows import gather_fine_windows_direct as jax_gather
from loftr_tpu_torch.models.fused_fine import fused_fine_forward
from loftr_tpu_torch.models.transformer import LocalFeatureTransformer
from loftr_tpu_torch.ops.fine_match import fine_kpts, fine_match
from loftr_tpu_torch.ops.kernels.fine_stage import fused_fine_stage
from loftr_tpu_torch.ops.windows import gather_fine_windows_direct
from loftr_tpu_torch.utils.weights import state_dict_from_jax

B, K, W2, C, H = 2, 4, 25, 128, 8   # full fine width, few windows


def _windows(seed):
    r = np.random.RandomState(seed)
    return ((r.randn(B, K, W2, C) * 0.5).astype(np.float32),
            (r.randn(B, K, W2, C) * 0.5).astype(np.float32))


def _stack(seed, win0, win1):
    tr = JaxLFT(C, H, ("self", "cross"), "linear")
    v = tr.init(jax.random.PRNGKey(seed), jnp.asarray(win0.reshape(-1, W2, C)),
                jnp.asarray(win1.reshape(-1, W2, C)))
    v = jax.tree.map(np.asarray, dict(v))
    sd = state_dict_from_jax({"params": {"loftr_fine": v["params"]}})
    port = LocalFeatureTransformer(C, H, ("self", "cross"))
    port.load_state_dict({k.split(".", 1)[1]: t for k, t in sd.items()})
    return tr, v, port


def test_kernel_plain_matches_jax_kernel():
    """Plain version of kernel C against the Pallas kernel (interpret mode)
    at the bar of test_fine_stage_fused.py:65."""
    win0, win1 = _windows(0)
    _, v, port = _stack(1, win0, win1)
    want = FusedFineStage(C, H, block_windows=4).apply(
        v, jnp.asarray(win0), jnp.asarray(win1))
    with torch.no_grad():
        got = fused_fine_forward(port, torch.from_numpy(win0),
                                 torch.from_numpy(win1))
    assert got.dtype == torch.float32 and got.shape == (B, K, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


def test_kernel_plain_matches_plain_stack_and_fine_match():
    """The kernel's function = plain fine transformer + fine_match, in the
    port and in JAX."""
    win0, win1 = _windows(2)
    tr, v, port = _stack(3, win0, win1)
    f0, f1 = tr.apply(v, jnp.asarray(win0.reshape(-1, W2, C)),
                      jnp.asarray(win1.reshape(-1, W2, C)))
    want = jax_fine_match(f0.reshape(B, K, W2, C), f1.reshape(B, K, W2, C))
    with torch.no_grad():
        g0, g1 = port(torch.from_numpy(win0.reshape(-1, W2, C)),
                      torch.from_numpy(win1.reshape(-1, W2, C)))
        plain = fine_match(g0.reshape(B, K, W2, C), g1.reshape(B, K, W2, C))
        kern = fused_fine_forward(port, torch.from_numpy(win0),
                                  torch.from_numpy(win1))
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(kern.numpy(), plain.numpy(), atol=2e-4,
                               rtol=2e-4)


def test_kernel_plain_bf16_tracks_jax_kernel():
    """bf16: rounding at the Pallas kernel's places; sums in another order
    may flip single roundings, so the bar is on window coordinates."""
    win0, win1 = _windows(4)
    _, v, port = _stack(5, win0, win1)
    want = np.asarray(FusedFineStage(C, H, block_windows=4).apply(
        v, jnp.asarray(win0, jnp.bfloat16), jnp.asarray(win1, jnp.bfloat16)))
    with torch.no_grad():
        got = fused_fine_forward(port, torch.from_numpy(win0).bfloat16(),
                                 torch.from_numpy(win1).bfloat16()).numpy()
    assert np.abs(got - want).max() < 5e-2


def test_windows_are_independent():
    win0, win1 = _windows(6)
    _, _, port = _stack(7, win0, win1)
    with torch.no_grad():
        base = fused_fine_forward(port, torch.from_numpy(win0),
                                  torch.from_numpy(win1))
        win0[0, 2] += 1.0
        pert = fused_fine_forward(port, torch.from_numpy(win0),
                                  torch.from_numpy(win1))
    torch.testing.assert_close(pert[0, :2], base[0, :2], atol=1e-6, rtol=0)
    assert not torch.allclose(pert[0, 2], base[0, 2], atol=1e-6)


def test_wrapper_uses_plain_version_on_cpu():
    before = fused_fine_stage.launches
    win = torch.zeros(3, W2, C)
    from loftr_tpu_torch.models.fused_fine import encoder_weights
    w = encoder_weights(LocalFeatureTransformer(C, H, ("self",)).layers[0])
    with torch.no_grad():
        out = fused_fine_stage(win, win, w, w, H)
    assert out.shape == (3, 3) and fused_fine_stage.launches == before


@pytest.mark.parametrize("hw", [(12, 16), (7, 9)])
def test_gather_windows_matches_jax(hw):
    r = np.random.RandomState(8)
    hc, wc = hw
    feat = r.randn(2, hc * 4, wc * 4, 16).astype(np.float32)
    ids = r.randint(0, hc * wc, (2, 10)).astype(np.int32)
    ids[0, :4] = [0, wc - 1, hc * wc - 1, (hc - 1) * wc]   # corners
    want = jax_gather(jnp.asarray(feat), jnp.asarray(ids), (hc, wc), 5, 4)
    got = gather_fine_windows_direct(torch.from_numpy(feat),
                                     torch.from_numpy(ids), (hc, wc), 5, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fine_kpts_keeps_reference_quirk():
    r = np.random.RandomState(9)
    e = r.rand(2, 6, 3).astype(np.float32) * 2 - 1
    k0 = r.rand(2, 6, 2).astype(np.float32) * 100
    k1 = r.rand(2, 6, 2).astype(np.float32) * 100
    sc = r.rand(2, 2).astype(np.float32) + 0.5
    w0, w1 = jax_fine_kpts(jnp.asarray(e), jnp.asarray(k0), jnp.asarray(k1),
                           5, 2, jnp.asarray(sc))
    g0, g1 = fine_kpts(torch.from_numpy(e), torch.from_numpy(k0),
                       torch.from_numpy(k1), 5, 2, torch.from_numpy(sc))
    np.testing.assert_array_equal(g0.numpy(), k0)   # mkpts0_f == mkpts0_c
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), rtol=1e-6)
