"""PyTorch port: the remaining model options against the JAX package, on
the same seeded numpy inputs (CPU, float32, tiny widths): the backbone's
``group`` and ``none`` norms, ``ResNetFPN_16_4`` with every norm, and
``full_attention`` (masked, with a fully masked row) in the op, the
transformer and the matcher."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu import LoFTR as JaxLoFTR
from loftr_tpu import MatchInput as JaxMatchInput
from loftr_tpu import get_config as jax_get_config
from loftr_tpu.models.backbone import build_backbone as jax_build_backbone
from loftr_tpu.models.transformer import \
    LocalFeatureTransformer as JaxTransformer
from loftr_tpu.ops.attention import full_attention as jax_full_attention
from loftr_tpu_torch import LoFTR, MatchInput, get_config
from loftr_tpu_torch.models.backbone import build_backbone
from loftr_tpu_torch.models.fused_fine import fused_fine_forward
from loftr_tpu_torch.models.transformer import LocalFeatureTransformer
from loftr_tpu_torch.ops.attention import full_attention
from loftr_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_slice import assert_slice_equal

DIMS = {(8, 2): (16, 24, 32), (16, 4): (16, 24, 32, 40)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes on a few
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(v, r):
    """Non-trivial norm affines, running statistics and folded biases."""
    v = jax.tree.map(np.array, dict(v))
    for coll in v:
        for path, leaf in jax.tree_util.tree_leaves_with_path(v[coll]):
            name = path[-1].key
            if name == "var":
                leaf[...] = r.rand(*leaf.shape) + 0.5
            elif name in ("mean", "bias"):
                leaf[...] = r.randn(*leaf.shape) * 0.1
            elif name == "scale":
                leaf[...] = r.rand(*leaf.shape) + 0.5
    return v


def _backbone_pair(resolution, norm, seed=0):
    r = np.random.RandomState(seed)
    x = r.rand(2, 64, 48, 1).astype(np.float32)
    dims = DIMS[resolution]
    jm = jax_build_backbone(resolution, 16, dims, norm)
    v = _randomize(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x)), r)
    sd = state_dict_from_jax({c: {"backbone": t} for c, t in v.items()})
    tm = build_backbone(resolution, 16, dims, norm)
    tm.load_state_dict({k[len("backbone."):]: t for k, t in sd.items()})
    return x, jm, v, tm.eval()


@pytest.mark.parametrize("resolution,norm", [
    ((8, 2), "group"), ((8, 2), "none"), ((16, 4), "batch"),
    ((16, 4), "group"), ((16, 4), "none")])
def test_backbone_option_matches_jax(resolution, norm):
    x, jm, v, tm = _backbone_pair(resolution, norm)
    want_c, want_f = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got_c, got_f = tm(torch.from_numpy(x))
    rc, rf = resolution
    assert got_c.shape == (2, 64 // rc, 48 // rc, DIMS[resolution][-1])
    assert got_f.shape == (2, 64 // rf, 48 // rf,
                           DIMS[resolution][-3 if rc == 8 else 1])
    for got, want in ((got_c, want_c), (got_f, want_f)):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-4 * np.abs(want).max(), rtol=1e-4)


def test_group_norm_trains_and_matches_jax():
    """GroupNorm normalises per sample, so the training forward equals the
    eval one in both frameworks; the port's gradients flow through it."""
    x, jm, v, tm = _backbone_pair((8, 2), "group", seed=3)
    want_c, _ = jm.apply(v, jnp.asarray(x), train=True)
    tm.train()
    got_c, got_f = tm(torch.from_numpy(x))
    want = np.asarray(want_c)
    np.testing.assert_allclose(got_c.detach().numpy(), want,
                               atol=1e-4 * np.abs(want).max(), rtol=1e-4)
    (got_c.sum() + got_f.sum()).backward()
    assert tm.bn1.weight.grad is not None
    assert torch.isfinite(tm.layer1[0].bn1.weight.grad).all()


def test_folded_backbone_refuses_training():
    tm = build_backbone((8, 2), 16, DIMS[(8, 2)], "none")
    tm.eval()
    with pytest.raises(ValueError, match="inference only"):
        tm.train()
    assert tm.conv1.bias is not None and not hasattr(tm.bn1, "weight")
    with pytest.raises(ValueError):
        build_backbone((8, 2), 16, DIMS[(8, 2)], "layer")
    with pytest.raises(ValueError):
        build_backbone((4, 1), 16, DIMS[(8, 2)], "batch")


@pytest.mark.parametrize("masked", [False, True])
def test_full_attention_matches_jax(masked):
    r = np.random.RandomState(5 + masked)
    B, L, S, H, D = 2, 12, 10, 2, 8
    q, k, v = (r.randn(B, n, H, D).astype(np.float32) for n in (L, S, S))
    qm = km = None
    if masked:
        qm = r.rand(B, L) > 0.3
        km = r.rand(B, S) > 0.3
        km[1] = False                      # every pair of batch 1 masked
        qm[0, 3] = False                   # one masked query row
    want = np.asarray(jax_full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if qm is None else jnp.asarray(qm),
        None if km is None else jnp.asarray(km)))
    got = full_attention(*map(torch.from_numpy, (q, k, v)),
                         None if qm is None else torch.from_numpy(qm),
                         None if km is None else torch.from_numpy(km))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    if masked:
        assert (got[1] == 0).all() and (got[0, 3] == 0).all()


def test_full_attention_transformer_matches_jax():
    r = np.random.RandomState(7)
    x0 = r.randn(2, 20, 16).astype(np.float32)
    x1 = r.randn(2, 20, 16).astype(np.float32)
    m0 = np.ones((2, 20), bool)
    m1 = np.ones((2, 20), bool)
    m0[1, 15:] = False
    m1[1, :] = False
    names = ("self", "cross")
    jt = JaxTransformer(16, 2, names, "full")
    args = [jnp.asarray(a) for a in (x0, x1, m0, m1)]
    params = jax.tree.map(np.asarray, jt.init(jax.random.PRNGKey(1), *args))
    w0, w1 = jt.apply(params, *args)
    sd = state_dict_from_jax({"params": {"loftr_coarse": params["params"]}})
    tt = LocalFeatureTransformer(16, 2, names, "full", fused_heads=True,
                                 fused_heads_eval=True)
    tt.load_state_dict({k[len("loftr_coarse."):]: t for k, t in sd.items()})
    g0, g1 = tt(*map(torch.from_numpy, (x0, x1, m0, m1)))
    for got, want in ((g0, w0), (g1, w1)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def _matcher_over(resolution, attention):
    dims = DIMS[resolution]
    return {"loftr": {
        "backbone": {"resolution": resolution, "initial_dim": 16,
                     "block_dims": dims},
        "coarse": {"d_model": dims[-1], "nhead": 4, "attention": attention,
                   "layer_names": ("self", "cross"), "use_pallas": True},
        "fine": {"d_model": dims[-3] if resolution == (8, 2) else dims[1],
                 "nhead": 2, "layer_names": ("self", "cross"),
                 "use_pallas": False},
        "match_coarse": {"max_matches": 16, "thr": 0.0, "border_rm": 0,
                         "use_pallas": False}}}


@pytest.mark.parametrize("resolution,attention,masked", [
    ((8, 2), "full", True), ((16, 4), "linear", False),
    ((16, 4), "full", False)])
def test_matcher_option_matches_jax(resolution, attention, masked):
    """The whole matcher with the option, from the images; the coarse
    stage's ``use_pallas`` is on in both, and with ``full`` both take the
    plain stack because the configured function is softmax attention."""
    r = np.random.RandomState(11)
    size = 64 if resolution == (8, 2) else 128
    i0 = r.rand(2, size, size, 1).astype(np.float32)
    i1 = r.rand(2, size, size, 1).astype(np.float32)
    kw = {}
    if masked:
        hc = size // resolution[0]
        m = np.zeros((2, hc, hc), bool)
        m[:, :hc - 2, :hc - 1] = True
        kw = dict(mask0=m, mask1=m)
    over = _matcher_over(resolution, attention)
    jm = JaxLoFTR(jax_get_config("indoor_ds", over).loftr)
    jinp = JaxMatchInput(image0=jnp.asarray(i0), image1=jnp.asarray(i1),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    v = jm.init(jax.random.PRNGKey(2), jinp)
    want = jm.apply(v, jinp)
    model = LoFTR(get_config("indoor_ds", over).loftr)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, dict(v))))
    tinp = MatchInput(image0=torch.from_numpy(i0),
                      image1=torch.from_numpy(i1),
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    got = model.eval()(tinp)
    assert int(np.asarray(want.valid).sum()) > 0
    assert_slice_equal(got, want)


def test_fine_kernel_refuses_full_attention():
    """The fine-stage kernel computes linear attention and raises when it
    is handed a softmax-attention stack."""
    over = _matcher_over((8, 2), "linear")
    over["loftr"]["fine"].update(attention="full")
    model = LoFTR(get_config("indoor_ds", over).loftr).eval()
    win = torch.zeros(1, 2, 25, 16)
    with pytest.raises(ValueError, match="linear attention only"):
        fused_fine_forward(model.loftr_fine, win, win)


@pytest.mark.parametrize("masked", [False, True])
def test_full_fine_attention_takes_the_plain_stack(masked):
    """``fine.attention='full'`` with the fine stage's ``use_pallas`` on
    runs, as in JAX, on the plain stack (the configured function is softmax
    attention) and matches JAX from the images."""
    r = np.random.RandomState(13)
    i0 = r.rand(2, 64, 64, 1).astype(np.float32)
    i1 = r.rand(2, 64, 64, 1).astype(np.float32)
    kw = {}
    if masked:
        m = np.zeros((2, 8, 8), bool)
        m[:, :6, :7] = True
        kw = dict(mask0=m, mask1=m)
    over = _matcher_over((8, 2), "linear")
    over["loftr"]["fine"].update(attention="full", use_pallas=True)
    jm = JaxLoFTR(jax_get_config("indoor_ds", over).loftr)
    jinp = JaxMatchInput(image0=jnp.asarray(i0), image1=jnp.asarray(i1),
                         **{k: jnp.asarray(v) for k, v in kw.items()})
    v = jm.init(jax.random.PRNGKey(4), jinp)
    want = jm.apply(v, jinp)
    model = LoFTR(get_config("indoor_ds", over).loftr)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, dict(v))))
    got = model.eval()(MatchInput(
        image0=torch.from_numpy(i0), image1=torch.from_numpy(i1),
        **{k: torch.from_numpy(v) for k, v in kw.items()}))
    assert int(np.asarray(want.valid).sum()) > 0
    assert_slice_equal(got, want)
