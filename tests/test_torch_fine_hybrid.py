"""PyTorch port: the hybrid fine stage (kernel-module forward, recomputed
plain backward) against loftr_tpu.ops.fine_stage_hybrid, at the bars of
tests/test_fine_hybrid.py: gradients 1e-4 / 1e-5, forward 5e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from loftr_tpu.models.transformer import (LocalFeatureTransformer as
                                          JaxTransformer)
from loftr_tpu.ops.fine_stage_hybrid import (fused_fine_stage_hybrid as
                                             jax_hybrid)
from loftr_tpu.ops.pallas.fine_stage import EncoderWeights as JaxWeights
from loftr_tpu_torch.models.fused_fine import fused_fine_forward
from loftr_tpu_torch.models.transformer import LocalFeatureTransformer
from loftr_tpu_torch.ops.fine_stage_hybrid import fused_fine_stage_hybrid
from loftr_tpu_torch.ops.kernels.fine_stage import (EncoderWeights,
                                                    fine_stage_plain)

NB, W2, C, H = 8, 25, 64, 8
FIELDS = ("q", "k", "v", "merge", "ln1_s", "ln1_b", "mlp0", "mlp2", "ln2_s",
          "ln2_b")


def _inputs(seed=0):
    r = np.random.RandomState(seed)
    win0 = (r.randn(NB, W2, C) * 0.5).astype(np.float32)
    win1 = (r.randn(NB, W2, C) * 0.5).astype(np.float32)
    tr = JaxTransformer(C, H, ("self", "cross"), "linear")
    v = tr.init(jax.random.PRNGKey(1), jnp.asarray(win0), jnp.asarray(win1))
    layers = []
    for i in (0, 1):
        p = v["params"][f"layer_{i}"]
        layers.append({
            "q": p["q_proj"]["kernel"], "k": p["k_proj"]["kernel"],
            "v": p["v_proj"]["kernel"], "merge": p["merge"]["kernel"],
            "ln1_s": p["norm1"]["scale"] + 0.1, "ln1_b": p["norm1"]["bias"],
            "mlp0": p["mlp_0"]["kernel"], "mlp2": p["mlp_2"]["kernel"],
            "ln2_s": p["norm2"]["scale"] - 0.1, "ln2_b": p["norm2"]["bias"]})
    layers = [{k: np.array(x, np.float32) for k, x in l.items()}
              for l in layers]
    g_out = r.randn(NB, 3).astype(np.float32)
    return win0, win1, layers, g_out


def test_hybrid_forward_and_grads_match_jax():
    win0, win1, layers, g_out = _inputs()
    jl = [JaxWeights(**{k: jnp.asarray(v) for k, v in l.items()})
          for l in layers]

    def jloss(a, b, p0, p1):
        return jnp.sum(jax_hybrid(a, b, p0, p1, H) * jnp.asarray(g_out))

    wg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        jnp.asarray(win0), jnp.asarray(win1), jl[0], jl[1])
    wout = jax_hybrid(jnp.asarray(win0), jnp.asarray(win1), jl[0], jl[1], H)

    a = torch.from_numpy(win0).requires_grad_(True)
    b = torch.from_numpy(win1).requires_grad_(True)
    tl = [EncoderWeights(**{k: torch.from_numpy(l[k]).requires_grad_(True)
                            for k in FIELDS}) for l in layers]
    out = fused_fine_stage_hybrid(a, b, tl[0], tl[1], H)
    assert out.shape == (NB, 3) and out.requires_grad
    (out * torch.from_numpy(g_out)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(wout),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(wg[0]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(wg[1]), rtol=1e-4,
                               atol=1e-5)
    for i in (0, 1):
        for k in FIELDS:
            np.testing.assert_allclose(
                getattr(tl[i], k).grad.numpy(),
                np.asarray(getattr(wg[2 + i], k)), rtol=1e-4, atol=1e-5,
                err_msg=f"layer {i} {k}")


def test_hybrid_grads_equal_autograd_of_the_plain_version():
    win0, win1, layers, g_out = _inputs(seed=4)

    def run(fn):
        a = torch.from_numpy(win0).requires_grad_(True)
        tl = [EncoderWeights(**{k: torch.from_numpy(l[k]).requires_grad_(True)
                                for k in FIELDS}) for l in layers]
        out = fn(a, torch.from_numpy(win1), tl[0], tl[1], H)
        (out * torch.from_numpy(g_out)).sum().backward()
        return out.detach(), a.grad, tl[1].mlp0.grad
    got, want = run(fused_fine_stage_hybrid), run(fine_stage_plain)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_trainable_fused_fine_forward_routes_grads_to_the_module():
    win0, win1, _, g_out = _inputs(seed=5)
    tr = LocalFeatureTransformer(C, H, ("self", "cross"))
    w0 = torch.from_numpy(win0).reshape(2, 4, W2, C).requires_grad_(True)
    w1 = torch.from_numpy(win1).reshape(2, 4, W2, C)
    out = fused_fine_forward(tr, w0, w1, trainable=True)
    assert out.shape == (2, 4, 3)
    (out.reshape(NB, 3) * torch.from_numpy(g_out)).sum().backward()
    assert w0.grad is not None and bool(torch.isfinite(w0.grad).all())
    for name, p in tr.named_parameters():
        assert p.grad is not None and float(p.grad.abs().sum()) > 0, name
    # and the plain stack gives the same gradients (same function)
    tr2 = LocalFeatureTransformer(C, H, ("self", "cross"))
    tr2.load_state_dict(tr.state_dict())
    from loftr_tpu_torch.ops.fine_match import fine_match
    f0, f1 = tr2(w0.detach().reshape(NB, W2, C), w1.reshape(NB, W2, C))
    o2 = fine_match(f0.reshape(2, 4, W2, C), f1.reshape(2, 4, W2, C))
    (o2.reshape(NB, 3) * torch.from_numpy(g_out)).sum().backward()
    for (n1, p1), (_, p2) in zip(tr.named_parameters(),
                                 tr2.named_parameters()):
        np.testing.assert_allclose(p1.grad.numpy(), p2.grad.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=n1)
