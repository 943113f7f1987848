"""PyTorch port: the training-only ops against the JAX package: match
selection from shared noise, the mask budget, the unfold window gather,
fused-heads linear attention, training-mode BatchNorm."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu.models.backbone import ResNetFPN_8_2 as JaxFPN
from loftr_tpu.ops import attention as JA
from loftr_tpu.ops import matching as JM
from loftr_tpu.ops import windows as JW
from loftr_tpu_torch.models.backbone import ResNetFPN_8_2
from loftr_tpu_torch.ops import attention as TA
from loftr_tpu_torch.ops import matching as TM
from loftr_tpu_torch.ops import windows as TW
from loftr_tpu_torch.utils.weights import state_dict_from_jax

from torch_train_common import jax_select_noise


def _cands(B, L, S, seed, n_valid, n_gt):
    rng = np.random.RandomState(seed)
    valid = np.zeros((B, L), bool)
    gt_valid = np.zeros((B, L), bool)
    for b in range(B):
        valid[b, rng.permutation(L)[:n_valid[b]]] = True
        gt_valid[b, rng.permutation(L)[:n_gt[b]]] = True
    j_ids = rng.randint(0, S, (B, L)).astype(np.int32)
    mconf = np.where(valid, rng.rand(B, L) * 0.8 + 0.2, 0).astype(np.float32)
    gt_j = rng.randint(0, S, (B, L)).astype(np.int32)
    return j_ids, mconf, valid, gt_j, gt_valid


@pytest.mark.parametrize("sampling,budget,n_valid,n_gt", [
    ("per_pair", None, (30, 3), (20, 9)),
    ("per_pair", (14, 40), (30, 3), (20, 9)),
    ("per_pair", None, (0, 50), (0, 5)),          # no candidates; no GT
    ("global_replacement", None, (30, 3), (20, 9)),
    ("global_replacement", (14, 40), (0, 25), (7, 0)),
])
def test_select_train_matches_slot_for_slot(sampling, budget, n_valid, n_gt):
    B, L, S, k_train, pad = 2, 64, 48, 16, 4
    j_ids, mconf, valid, gt_j, gt_valid = _cands(B, L, S, 3, n_valid, n_gt)
    key = jax.random.PRNGKey(5)
    jb = None if budget is None else jnp.asarray(budget, jnp.int32)
    want = JM.select_train_matches(
        JM.CandidateMatches(jnp.asarray(j_ids), jnp.asarray(mconf),
                            jnp.asarray(valid)),
        jnp.asarray(gt_j), jnp.asarray(gt_valid), key, k_train, pad,
        budget=jb, sampling=sampling)
    noise = jax_select_noise(key, B, L, k_train, sampling)
    got = TM.select_train_matches(
        TM.CandidateMatches(torch.from_numpy(j_ids), torch.from_numpy(mconf),
                            torch.from_numpy(valid)),
        torch.from_numpy(gt_j), torch.from_numpy(gt_valid), None, k_train,
        pad, budget=None if budget is None else torch.tensor(
            budget, dtype=torch.int32), sampling=sampling, noise=noise)
    for name in ("i_ids", "j_ids", "mask", "gt_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    np.testing.assert_array_equal(got.mconf.numpy(), np.asarray(want.mconf))
    assert got.i_ids.dtype == torch.int32 and got.j_ids.dtype == torch.int32


def test_select_train_matches_generator_is_seeded():
    B, L, S = 2, 64, 48
    j_ids, mconf, valid, gt_j, gt_valid = _cands(B, L, S, 4, (30, 10), (20, 9))
    cand = TM.CandidateMatches(torch.from_numpy(j_ids),
                               torch.from_numpy(mconf),
                               torch.from_numpy(valid))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return TM.select_train_matches(cand, torch.from_numpy(gt_j),
                                       torch.from_numpy(gt_valid), g, 16, 4)
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a.i_ids, b.i_ids) and not torch.equal(a.i_ids, c.i_ids)
    # at most k_train - pad predicted slots, the rest GT rows of the table
    assert int((~a.gt_mask).sum(1).max()) <= 12
    rows = a.i_ids[a.gt_mask].long()
    assert bool(torch.from_numpy(gt_valid).reshape(-1)[
        (torch.arange(B)[:, None] * L + a.i_ids.long())[a.gt_mask]].all())
    assert rows.numel() > 0
    with pytest.raises(ValueError):
        TM.select_train_matches(cand, torch.from_numpy(gt_j),
                                torch.from_numpy(gt_valid), None, 4, 4)


def test_mask_match_budget_matches_jax():
    m0 = np.zeros((3, 8, 10), bool)
    m1 = np.zeros((3, 8, 10), bool)
    for b, (h0, w0, h1, w1) in enumerate([(8, 10, 6, 7), (5, 5, 8, 10),
                                          (3, 9, 7, 2)]):
        m0[b, :h0, :w0] = True
        m1[b, :h1, :w1] = True
    m0[0, 2, 3] = False    # a hole does not change the extents
    for pct in (0.2, 0.3):
        want = JM.mask_match_budget(jnp.asarray(m0), jnp.asarray(m1), pct)
        got = TM.mask_match_budget(torch.from_numpy(m0), torch.from_numpy(m1),
                                   pct)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32


@pytest.mark.parametrize("hc,wc,stride,window", [(8, 8, 4, 5), (6, 10, 4, 5),
                                                 (5, 7, 2, 3)])
def test_unfold_gather_equals_direct_and_jax(hc, wc, stride, window):
    rng = np.random.RandomState(1)
    B, C, K = 2, 6, 9
    feat = rng.randn(B, hc * stride, wc * stride, C).astype(np.float32)
    ids = rng.randint(0, hc * wc, (B, K)).astype(np.int32)
    ids[0, :4] = [0, wc - 1, (hc - 1) * wc, hc * wc - 1]   # the corners
    want = JW.gather_fine_windows(jnp.asarray(feat), jnp.asarray(ids),
                                  (hc, wc), window, stride)
    ft = torch.from_numpy(feat).requires_grad_(True)
    got = TW.gather_fine_windows(ft, torch.from_numpy(ids), (hc, wc), window,
                                 stride)
    direct = TW.gather_fine_windows_direct(ft, torch.from_numpy(ids),
                                           (hc, wc), window, stride)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.detach().numpy(),
                                  direct.detach().numpy())
    # the two gathers have the same gradient
    g = torch.from_numpy(rng.randn(*got.shape).astype(np.float32))
    ga, = torch.autograd.grad((got * g).sum(), ft)
    gb, = torch.autograd.grad((direct * g).sum(), ft)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("masked,dtype", [(False, "float32"),
                                          (True, "float32"),
                                          (False, "bfloat16")])
def test_fused_heads_attention_matches_plain_and_jax(masked, dtype):
    rng = np.random.RandomState(2)
    B, L, S, H, D = 2, 25, 30, 4, 8
    q, k, v = (rng.randn(B, n, H, D).astype(np.float32) for n in (L, S, S))
    qm = rng.rand(B, L) > 0.2 if masked else None
    km = rng.rand(B, S) > 0.2 if masked else None
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jn = lambda x: None if x is None else jnp.asarray(x)
    tn = lambda x: None if x is None else torch.from_numpy(x)
    want = JA.linear_attention_fused_heads(
        jn(q).astype(jdt), jn(k).astype(jdt), jn(v).astype(jdt), jn(qm),
        jn(km))
    got = TA.linear_attention_fused_heads(tn(q).to(tdt), tn(k).to(tdt),
                                          tn(v).to(tdt), tn(qm), tn(km))
    plain = TA.linear_attention(tn(q).to(tdt), tn(k).to(tdt), tn(v).to(tdt),
                                tn(qm), tn(km))
    assert got.dtype == tdt and got.shape == (B, L, H, D)
    # float32: summation order only (the bar of tests/test_ops.py for the
    # fused-heads oracle); bfloat16: one output ulp at |y| ~ 2
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=tol, atol=tol)


def test_encoder_layer_uses_fused_heads_only_in_train_mode(monkeypatch):
    from loftr_tpu_torch.models import transformer as T
    calls = []
    real = T.linear_attention_fused_heads
    monkeypatch.setattr(T, "linear_attention_fused_heads",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tr = T.LocalFeatureTransformer(16, 2, ("self", "cross"),
                                   fused_heads=True)
    x = torch.randn(2, 9, 16, generator=torch.Generator().manual_seed(0))
    tr.train()(x, x)
    assert len(calls) == 3        # packed self + two cross directions
    a = tr.eval()(x, x)
    assert len(calls) == 3
    b = tr.train()(x, x)
    np.testing.assert_allclose(a[0].detach().numpy(), b[0].detach().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_training_batchnorm_matches_flax():
    """Outputs on batch statistics, and the updated running mean and
    *biased* running variance, against flax's nn.BatchNorm."""
    rng = np.random.RandomState(3)
    x = rng.rand(4, 32, 32, 1).astype(np.float32)
    jm = JaxFPN(8, (8, 12, 16))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    (wc, wf), mutated = jm.apply(v, jnp.asarray(x), True,
                                 mutable=["batch_stats"])
    tm = ResNetFPN_8_2(8, (8, 12, 16))
    tm.load_state_dict({k[len("backbone."):]: t for k, t in
                        state_dict_from_jax({
                            "params": {"backbone": jax.tree.map(
                                np.asarray, v["params"])},
                            "batch_stats": {"backbone": jax.tree.map(
                                np.asarray, v["batch_stats"])}}).items()})
    gc, gf = tm.train()(torch.from_numpy(x))
    np.testing.assert_allclose(gc.detach().numpy(), np.asarray(wc),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(gf.detach().numpy(), np.asarray(wf),
                               rtol=2e-4, atol=2e-4)
    want = state_dict_from_jax({
        "params": {"backbone": jax.tree.map(np.asarray, v["params"])},
        "batch_stats": {"backbone": jax.tree.map(
            np.asarray, mutated["batch_stats"])}})
    got = tm.state_dict()
    n = 0
    for key, w in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key[len("backbone."):]].numpy(),
                                       w.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=key)
            n += 1
    assert n == 2 * 17
    # the biased variance: with N*H*W = 4 elements per channel the unbiased
    # one would be 4/3 of it
    bn = torch.nn.BatchNorm2d(3)
    from loftr_tpu_torch.models.backbone import apply_bn
    z = torch.from_numpy(rng.randn(1, 3, 2, 2).astype(np.float32))
    apply_bn(bn.train(), z)
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        0.9 + 0.1 * z.var(dim=(0, 2, 3), unbiased=False).numpy(), rtol=1e-6)
    assert int(bn.num_batches_tracked) == 1
