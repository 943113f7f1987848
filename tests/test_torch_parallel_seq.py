"""PyTorch port: sequence-parallel attention across two gloo ranks on the
CPU (``loftr_tpu_torch.parallel.seq_attention``) against JAX's
single-device attention, and a matcher with ``coarse.seq_axis`` against
the unsharded one.

  - ``seq_parallel_linear_attention`` and ``ring_full_attention`` on
    ``tests/test_parallel.py``'s shapes (B = 2, L = 64, H = 4, D = 8, 32
    tokens a rank, random masks; for full attention one image with every
    key masked): outputs and the gradients of sum(out * w) with respect to
    q, k and v against ``loftr_tpu.ops.attention``'s ``linear_attention``
    / ``full_attention`` under ``jax.grad``, at that file's 2e-4;
  - the coarse layer stack (two layers, d 32, 4 heads, masks) sharded over
    the tokens against the port's unsharded stack, linear and full:
    outputs within 1e-5, and for a loss every rank forms alike on the
    gathered tokens, every rank's gradients of the input tokens and of the
    parameters (the unsharded stack's, as JAX's replicated program gives
    them) within 1e-5 of each tensor's largest entry;
  - a narrow matcher in eval mode (64 x 64 images) with ``coarse.seq_axis =
    'seq'`` under a ('data', 'seq') = (1, 2) mesh against the same weights
    with the plain unsharded stack: coarse features within 1e-5, the same
    matches, confidences within 1e-5.

The ranks run once, in a module fixture (``tests/torch_parallel_worker.
py::seq_check``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.ops.attention import full_attention as jax_full
from loftr_tpu.ops.attention import linear_attention as jax_linear
from loftr_tpu_torch import get_config
from loftr_tpu_torch.models.matcher import LoFTR
from loftr_tpu_torch.models.transformer import LocalFeatureTransformer
from loftr_tpu_torch.structs import MatchInput
from loftr_tpu_torch.utils.weights import init_weights

from torch_parallel_worker import save_spec, start_ranks, wait_ranks
from torch_train_common import TINY, train_batch

B, L, H, D = 2, 64, 4, 8
STACK = dict(d=32, h=4, names=("self", "cross"))
MATCHER = {"loftr": {**TINY, "coarse": {**TINY["coarse"],
                                        "seq_axis": "seq"},
                     "match_coarse": {"thr": 0.0}}}


def _attention_inputs():
    rng = np.random.RandomState(0)
    a = {n: rng.randn(B, L, H, D).astype(np.float32) for n in "qkvw"}
    for kind in ("linear", "full"):
        a["qm_" + kind] = rng.rand(B, L) > 0.2
        a["km_" + kind] = rng.rand(B, L) > 0.2
    a["km_full"][1, :] = False      # every key of image 1 masked
    return a


def _jax_reference(a):
    out = {}
    for kind, fn in (("linear", jax_linear), ("full", jax_full)):
        args = [jnp.asarray(a[n]) for n in "qkv"]
        masks = [jnp.asarray(a[n + kind].astype(np.float32))
                 for n in ("qm_", "km_")]

        def loss(q, k, v):
            return jnp.sum(fn(q, k, v, *masks) * jnp.asarray(a["w"]))
        grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
        out[kind] = (np.asarray(fn(*args, *masks)),
                     [np.asarray(g) for g in grads])
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq")
    handle = start_ranks("seq", out, timeout=120)
    a = _attention_inputs()
    rng = np.random.RandomState(1)
    t = torch.from_numpy
    stack = {"f0": t(rng.randn(B, L, STACK["d"]).astype(np.float32)),
             "f1": t(rng.randn(B, L, STACK["d"]).astype(np.float32)),
             "w0": t(rng.randn(B, L, STACK["d"]).astype(np.float32)),
             "w1": t(rng.randn(B, L, STACK["d"]).astype(np.float32)),
             "m0": t(rng.rand(B, L) > 0.1), "m1": t(rng.rand(B, L) > 0.1),
             **STACK}
    for kind in ("linear", "full"):
        torch.manual_seed(3)
        s = LocalFeatureTransformer(STACK["d"], STACK["h"], STACK["names"],
                                    kind)
        stack["state_" + kind] = s.state_dict()
    cfg = get_config("indoor_ds", MATCHER)
    model = LoFTR(cfg.loftr)
    init_weights(model, 0)
    batch = {k: t(v) for k, v in train_batch(B=1, seed=2).items()
             if k in ("image0", "image1")}
    save_spec({"attention": {k: t(np.ascontiguousarray(v))
                             for k, v in a.items()},
               "stack": stack,
               "matcher": {"overrides": MATCHER,
                           "state": model.state_dict(), "batch": batch}},
              str(out / "seq_spec.pt"))

    want = _jax_reference(a)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stack_want = {}
        for kind in ("linear", "full"):
            s = LocalFeatureTransformer(STACK["d"], STACK["h"],
                                        STACK["names"], kind)
            s.load_state_dict(stack["state_" + kind])
            f0, f1 = (stack[k].clone().requires_grad_(True)
                      for k in ("f0", "f1"))
            c0, c1 = s(f0, f1, stack["m0"], stack["m1"])
            ((c0 * stack["w0"]).sum() + (c1 * stack["w1"]).sum()).backward()
            stack_want[kind] = {"c0": c0.detach(), "c1": c1.detach(),
                                "param_grads": {k: p.grad for k, p in
                                                s.named_parameters()},
                                "f0_grad": f0.grad, "f1_grad": f1.grad}
        plain = LoFTR(get_config("indoor_ds", {"loftr": {
            **MATCHER["loftr"], "coarse": {**TINY["coarse"],
                                           "use_pallas": False}}}).loftr)
        plain.load_state_dict(model.state_dict())
        plain.eval()
        with torch.no_grad():
            inp = MatchInput(**batch)
            matcher_want = {"coarse": plain.coarse(plain.extract(inp))[:2],
                            "out": plain(inp)}
    finally:
        torch.set_num_threads(n)
    return dict(recs=wait_ranks(handle), want=want, stack=stack_want,
                matcher=matcher_want)


def _slice(x, r):
    return x[:, r * (L // 2):(r + 1) * (L // 2)]


@pytest.mark.parametrize("kind", ["linear", "full"])
def test_sharded_attention_matches_jax(run, kind):
    want_out, want_grads = run["want"][kind]
    for r, rec in enumerate(run["recs"]):
        got = rec[kind]
        np.testing.assert_allclose(got["out"].numpy(), _slice(want_out, r),
                                   rtol=2e-4, atol=2e-4)
        for name, g, w in zip("qkv", got["grads"], want_grads):
            np.testing.assert_allclose(g.numpy(), _slice(w, r), rtol=2e-4,
                                       atol=2e-4, err_msg=name)
    if kind == "full":                 # image 1: every key masked
        assert not np.any(want_out[1])
        for rec in run["recs"]:
            assert not torch.any(rec[kind]["out"][1])


@pytest.mark.parametrize("kind", ["linear", "full"])
def test_sharded_stack_matches_unsharded(run, kind):
    want = run["stack"][kind]
    recs = [rec["stack_" + kind] for rec in run["recs"]]
    for rec in recs:
        for k in ("c0", "c1"):
            np.testing.assert_allclose(rec[k].numpy(), want[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    grads = [(k, rec[k], want[k]) for rec in recs
             for k in ("f0_grad", "f1_grad")]
    grads += [(k, rec["param_grads"][k], w) for rec in recs
              for k, w in want["param_grads"].items()]
    for k, g, w in grads:
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_matcher_with_seq_axis_matches_unsharded(run):
    want = run["matcher"]
    for rec in run["recs"]:
        got = rec["matcher"]
        for g, w in zip(got["coarse"], want["coarse"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5)
        go, wo = got["out"], want["out"]
        for name in ("i_ids", "j_ids", "mask"):
            assert torch.equal(getattr(go.coarse, name),
                               getattr(wo.coarse, name)), name
        np.testing.assert_allclose(go.coarse.mconf.numpy(),
                                   wo.coarse.mconf.numpy(), rtol=1e-5,
                                   atol=1e-6)
