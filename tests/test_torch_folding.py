"""PyTorch port: the inference weight transforms against the JAX package
(``utils/folding.py``, ``utils/channel_pad.py``, ``api.optimize_variables``)
on the same seeded variables, and the transformed port forward against
the batch-norm port forward at the bars of tests/test_folding.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu import LoFTR as JaxLoFTR
from loftr_tpu import MatchInput as JaxMatchInput
from loftr_tpu import get_config as jax_get_config
from loftr_tpu.api import optimize_variables as jax_optimize
from loftr_tpu.utils.channel_pad import \
    infer_backbone_overrides as jax_infer
from loftr_tpu.utils.channel_pad import \
    pad_backbone_channels as jax_pad
from loftr_tpu.utils.folding import fold_batchnorm as jax_fold
from loftr_tpu_torch import LoFTR, MatchInput, get_config
from loftr_tpu_torch.api import load_matcher, match_pair, optimize_variables
from loftr_tpu_torch.models.backbone import ResNetFPN_8_2
from loftr_tpu_torch.utils.channel_pad import (infer_backbone_overrides,
                                               pad_backbone_channels,
                                               pad_config)
from loftr_tpu_torch.utils.folding import fold_batchnorm, fold_config
from loftr_tpu_torch.utils.weights import init_weights, state_dict_from_jax

OVER = {"loftr": {"dtype": "float32",
                  "match_coarse": {"max_matches": 64, "use_pallas": False},
                  "fine": {"use_pallas": False}}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize_bn(v, r):
    """Non-trivial BatchNorm affines and statistics (tests/test_folding.py
    ``_randomize_bn``'s ranges)."""
    v = jax.tree.map(np.array, dict(v))
    for coll in v:
        for path, leaf in jax.tree_util.tree_leaves_with_path(v[coll]):
            if path[-2].key != "bn":
                continue
            n = leaf.shape
            leaf[...] = {"mean": lambda: r.randn(*n) * 0.5,
                         "var": lambda: r.rand(*n) * 2 + 0.1,
                         "scale": lambda: r.rand(*n) + 0.5,
                         "bias": lambda: r.randn(*n) * 0.2}[path[-1].key]()
    return v


@pytest.fixture(scope="module")
def full():
    """indoor_ds at its published widths (196 in the middle stage), JAX's
    seeded init with randomised BatchNorms, one 64x64 pair."""
    r = np.random.RandomState(1)
    i0 = r.rand(1, 64, 64, 1).astype(np.float32)
    i1 = r.rand(1, 64, 64, 1).astype(np.float32)
    jm = JaxLoFTR(jax_get_config("indoor_ds", OVER).loftr)
    jinp = JaxMatchInput(image0=jnp.asarray(i0), image1=jnp.asarray(i1))
    v = _randomize_bn(jax.jit(jm.init)(jax.random.PRNGKey(0), jinp), r)
    tinp = MatchInput(image0=torch.from_numpy(i0),
                      image1=torch.from_numpy(i1))
    return v, tinp


def _assert_state_equal(got, want_tree, atol=1e-6):
    want = state_dict_from_jax(jax.tree.map(np.asarray, dict(want_tree)))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("transform", ["fold", "pad", "fold_pad", "optimize"])
def test_transform_matches_jax(full, transform):
    v, _ = full
    sd = state_dict_from_jax(v)
    if transform == "fold":
        got, want = fold_batchnorm(sd), jax_fold(v)
    elif transform == "pad":
        got, want = pad_backbone_channels(sd), jax_pad(v)
    elif transform == "fold_pad":
        got = pad_backbone_channels(fold_batchnorm(sd))
        want = jax_pad(jax_fold(v))
    else:
        got, want = optimize_variables(sd), jax_optimize(v)
    _assert_state_equal(got, want)
    assert infer_backbone_overrides(got) == jax_infer(
        jax.tree.map(np.asarray, dict(want)))


def test_infer_backbone_overrides_on_every_tree(full):
    v, _ = full
    sd = state_dict_from_jax(v)
    trees = {"batch": sd, "folded": fold_batchnorm(sd),
             "padded": pad_backbone_channels(sd),
             "folded_padded": pad_backbone_channels(fold_batchnorm(sd))}
    want = {"batch": ("batch", (128, 196, 256)),
            "folded": ("none", (128, 196, 256)),
            "padded": ("batch", (128, 256, 256)),
            "folded_padded": ("none", (128, 256, 256))}
    for name, tree in trees.items():
        bb = infer_backbone_overrides(tree)["backbone"]
        assert (bb["norm"], bb["block_dims"]) == want[name], name
    gn = ResNetFPN_8_2(16, (16, 24, 32), "group").state_dict()
    bb = infer_backbone_overrides(
        {"backbone." + k: t for k, t in gn.items()})["backbone"]
    assert bb == {"norm": "group", "block_dims": (16, 24, 32)}


def test_fold_requires_batch_stats(full):
    with pytest.raises(KeyError):
        fold_batchnorm({"backbone.conv1.weight": torch.zeros(4, 1, 7, 7)})
    v, _ = full
    with pytest.raises(KeyError):
        fold_batchnorm(fold_batchnorm(state_dict_from_jax(v)))


def _run(state, cfg, inp):
    model = LoFTR(cfg.loftr)
    model.load_state_dict(state)
    return model.eval()(inp)


def test_backbone_folding_matches_bn_eval():
    """tests/test_folding.py::test_backbone_folding_matches_bn_eval."""
    r = np.random.RandomState(0)
    bn = init_weights(ResNetFPN_8_2(32, (32, 48, 64), "batch"), 0).eval()
    with torch.no_grad():
        for m in bn.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.from_numpy(r.randn(n) * 0.5))
                m.running_var.copy_(torch.from_numpy(r.rand(n) * 2 + 0.1))
                m.weight.copy_(torch.from_numpy(r.rand(n) + 0.5))
                m.bias.copy_(torch.from_numpy(r.randn(n) * 0.2))
    x = torch.from_numpy(r.rand(2, 64, 64, 1).astype(np.float32))
    folded = fold_batchnorm(
        {"backbone." + k: t for k, t in bn.state_dict().items()})
    none = ResNetFPN_8_2(32, (32, 48, 64), "none")
    none.load_state_dict({k[len("backbone."):]: t
                          for k, t in folded.items()})
    with torch.no_grad():
        ref = bn(x)
        got = none.eval()(x)
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=5e-4,
                                   atol=5e-4)


def test_matcher_folding_and_padding_keep_the_function(full):
    """Folded against batch (test_folding.py:60-88's bars), padded against
    unpadded (:98-124) and folded + padded against batch (:127-147), all
    through the port's full-width matcher."""
    v, inp = full
    sd = state_dict_from_jax(v)
    cfg = get_config("indoor_ds", OVER)
    ref = _run(sd, cfg, inp)

    fcfg = fold_config(cfg)
    assert fcfg.loftr.backbone.norm == "none"
    folded = fold_batchnorm(sd)
    assert not any("running" in k for k in folded)
    got = _run(folded, fcfg, inp)
    np.testing.assert_allclose(got.conf_matrix.numpy(),
                               ref.conf_matrix.numpy(), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got.expec_f.numpy(), ref.expec_f.numpy(),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.mkpts0_f.numpy(), ref.mkpts0_f.numpy(),
                               atol=5e-3)

    pcfg = pad_config(cfg)
    assert pcfg.loftr.backbone.block_dims == (128, 256, 256)
    got = _run(pad_backbone_channels(sd), pcfg, inp)
    np.testing.assert_allclose(got.coarse.mconf.numpy(),
                               ref.coarse.mconf.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.expec_f.numpy(), ref.expec_f.numpy(),
                               atol=1e-5)

    got = _run(optimize_variables(sd), pad_config(fcfg), inp)
    np.testing.assert_allclose(got.expec_f.numpy(), ref.expec_f.numpy(),
                               atol=2e-4)


def test_entry_points_take_transformed_weights(full):
    """load_matcher(state_dict=...) and match_pair read norm and dims off
    the transformed state, as loftr_tpu.api does."""
    v, inp = full
    sd = optimize_variables(state_dict_from_jax(v))
    m = load_matcher(device="cpu", state_dict=sd)
    assert m.config.backbone.norm == "none"
    assert m.config.backbone.block_dims == (128, 256, 256)
    assert m.backbone.conv1.bias is not None
    img0 = inp.image0[0, :, :, 0].numpy()
    img1 = inp.image1[0, :, :, 0].numpy()
    a = match_pair(img0, img1, m, dtype="float32")
    b = match_pair(img0, img1, sd, dtype="float32", device="cpu")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="inference only"):
        m.train()
