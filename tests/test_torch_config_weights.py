"""PyTorch port: config presets, weight conversion, package isolation and
device rules (loftr_tpu_torch against loftr_tpu)."""
import ast
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loftr_tpu.config as jcfg
import loftr_tpu_torch.config as tcfg
from loftr_tpu import LoFTR as JaxLoFTR, MatchInput as JaxMatchInput
from loftr_tpu.utils.weights import convert_torch_state_dict
from loftr_tpu_torch.models.matcher import LoFTR
from loftr_tpu_torch.utils.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "loftr_tpu_torch")

SMALL = {"loftr": {
    "backbone": {"initial_dim": 16, "block_dims": (16, 24, 32)},
    "coarse": {"d_model": 32, "nhead": 4, "layer_names": ("self", "cross")},
    "fine": {"d_model": 16, "nhead": 2, "layer_names": ("self", "cross")},
    "match_coarse": {"max_matches": 16}}}


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_presets_equal_jax_field_by_field(name):
    assert set(tcfg.PRESETS) == set(jcfg.PRESETS)
    assert dataclasses.asdict(tcfg.get_config(name)) == \
        dataclasses.asdict(jcfg.get_config(name))


def test_overrides_merge_like_jax():
    a = tcfg.get_config("indoor_ds", SMALL)
    b = jcfg.get_config("indoor_ds", SMALL)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    with pytest.raises(KeyError):
        tcfg.get_config("default", {"loftr": {"no_such_field": 1}})


def _jax_init(cfg, hw=64):
    inp = JaxMatchInput(image0=jnp.zeros((1, hw, hw, 1), jnp.float32),
                        image1=jnp.zeros((1, hw, hw, 1), jnp.float32))
    v = JaxLoFTR(cfg.loftr).init(jax.random.PRNGKey(0), inp)
    return jax.tree.map(np.asarray, dict(v))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_state_dict_round_trip_through_jax_converter():
    """JAX init -> state_dict_from_jax -> convert_torch_state_dict gives
    back the original tree, leaf for leaf; the port loads it strictly."""
    _round_trip("indoor_ds")


@pytest.mark.parametrize("preset", ["indoor_ot", "outdoor_ot",
                                    "indoor_ot_buggy_pos_enc"])
def test_bin_score_round_trips_through_jax_converter(preset):
    """The OT presets carry the scalar ``bin_score`` both ways."""
    _round_trip(preset)


def _round_trip(preset):
    cfg = jcfg.get_config(preset, SMALL)
    v = _jax_init(cfg)
    ot = preset != "indoor_ds"
    assert ("bin_score" in v["params"]) == ot
    if ot:
        v["params"]["bin_score"] = np.float32(0.37)
    sd = state_dict_from_jax(v)
    model = LoFTR(tcfg.get_config(preset, SMALL).loftr)
    model.load_state_dict(sd, strict=True)
    assert ("coarse_matching.bin_score" in sd) == ot
    if ot:
        assert sd["coarse_matching.bin_score"].shape == ()
        assert model.coarse_matching.bin_score.item() == np.float32(0.37)
        assert isinstance(model.coarse_matching.bin_score,
                          torch.nn.Parameter)
    back = convert_torch_state_dict({k: t.numpy() for k, t in sd.items()})
    want = dict(_flat(v))
    got = dict(_flat(back))
    assert set(got) == set(want)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))


def test_full_width_indoor_ds_keys_and_shapes():
    """Every leaf of the full-width indoor_ds JAX tree maps onto the port's
    module of the same shape (shapes only: no compute)."""
    cfg = jcfg.get_config("indoor_ds")
    inp = JaxMatchInput(image0=jnp.zeros((1, 64, 64, 1), jnp.float32),
                        image1=jnp.zeros((1, 64, 64, 1), jnp.float32))
    shapes = jax.eval_shape(JaxLoFTR(cfg.loftr).init,
                            jax.random.PRNGKey(0), inp)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         dict(shapes))
    sd = state_dict_from_jax(zeros)
    model = LoFTR(tcfg.get_config("indoor_ds").loftr)
    model.load_state_dict(sd, strict=True)
    assert len(sd) == len(model.state_dict())


def test_bin_score_initialises_from_the_config():
    from loftr_tpu_torch.utils.weights import init_weights
    over = {"loftr": {**SMALL["loftr"], "match_coarse": {
        "max_matches": 16, "skh_init_bin_score": 0.25}}}
    model = init_weights(LoFTR(tcfg.get_config("indoor_ot", over).loftr), 3)
    assert model.coarse_matching.bin_score.item() == 0.25
    assert not hasattr(LoFTR(tcfg.get_config("indoor_ds", SMALL).loftr),
                       "coarse_matching")
    with pytest.raises(NotImplementedError):
        LoFTR(tcfg.get_config("indoor_ds", {"loftr": {"match_coarse": {
            "match_type": "nearest"}}}).loftr)


def test_unmapped_leaf_raises():
    with pytest.raises(KeyError):
        state_dict_from_jax({"params": {"mystery": {"kernel": np.zeros(2)}}})


def test_import_leaves_jax_out():
    code = ("import sys, loftr_tpu_torch, loftr_tpu_torch.api, "
            "loftr_tpu_torch.ops.kernels.coarse_layer, "
            "loftr_tpu_torch.ops.kernels.dual_softmax, "
            "loftr_tpu_torch.ops.kernels.fine_stage, "
            "loftr_tpu_torch.ops.kernels.focal_loss, "
            "loftr_tpu_torch.ops.kernels.sinkhorn, "
            "loftr_tpu_torch.ops.kernels.window_attention, "
            "loftr_tpu_torch.ops.kernels.upsample, "
            "loftr_tpu_torch.ops.sinkhorn, "
            "loftr_tpu_torch.ops.fine_stage_hybrid, loftr_tpu_torch.losses, "
            "loftr_tpu_torch.supervision, loftr_tpu_torch.train.optim, "
            "loftr_tpu_torch.train.trainer, "
            "loftr_tpu_torch.train.checkpoint, loftr_tpu_torch.data, "
            "loftr_tpu_torch.data.augment, loftr_tpu_torch.data.io, "
            "loftr_tpu_torch.data.synthetic, loftr_tpu_torch.eval.metrics, "
            "loftr_tpu_torch.eval.pose, loftr_tpu_torch.eval.five_point, "
            "loftr_tpu_torch.eval.five_point_batched, "
            "loftr_tpu_torch.eval.ransac, loftr_tpu_torch.eval.evaluator, "
            "loftr_tpu_torch.native, loftr_tpu_torch.test, "
            "loftr_tpu_torch.utils.plotting, loftr_tpu_torch.utils.logging, "
            "loftr_tpu_torch.train.cli, "
            "loftr_tpu_torch.tools.synthetic_benchmark, "
            "loftr_tpu_torch.tools.seed_sweep, "
            "loftr_tpu_torch.utils.folding, "
            "loftr_tpu_torch.utils.channel_pad, loftr_tpu_torch.serve, "
            "loftr_tpu_torch.serve.service\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', "
            "'orbax', 'loftr_tpu') or m.startswith(('jax.', 'flax.', "
            "'optax.', 'orbax.', 'loftr_tpu.'))]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _is_forbidden(mod):
    return any(mod == p or mod.startswith(p + ".")
               for p in ("jax", "flax", "optax", "orbax", "loftr_tpu"))


@pytest.mark.parametrize("root", ["loftr_tpu_torch", "chip_smoke.py",
                                  "tests/test_torch_upsample_card.py"])
def test_no_jax_imports_in_port_sources(root):
    path = os.path.join(REPO, root)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
        if f.endswith(".py")]
    assert files
    bad = [(f, m) for f in files for m in _imports(f) if _is_forbidden(m)]
    assert bad == []
    assert not _is_forbidden("loftr_tpu_torch.api")
    assert _is_forbidden("optax") and _is_forbidden("orbax.checkpoint")
    if root == "loftr_tpu_torch":
        names = {os.path.relpath(f, path) for f in files}
        assert {"losses.py", "supervision.py", "train/trainer.py",
                "train/optim.py", "train/checkpoint.py",
                "ops/kernels/focal_loss.py", "ops/fine_stage_hybrid.py",
                "ops/sinkhorn.py", "ops/kernels/sinkhorn.py",
                "ops/kernels/window_attention.py",
                "ops/kernels/upsample.py", "eval/evaluator.py",
                "eval/ransac.py", "eval/five_point_batched.py",
                "data/loader.py", "native.py", "test.py", "train/cli.py",
                "train/__main__.py", "utils/logging.py",
                "tools/synthetic_benchmark.py", "tools/seed_sweep.py",
                "utils/folding.py", "utils/channel_pad.py",
                "serve/__init__.py", "serve/service.py",
                "parallel/__init__.py", "parallel/comm.py",
                "parallel/mesh.py", "parallel/seq_attention.py"} <= names


def test_service_default_device_needs_cuda(monkeypatch):
    from loftr_tpu_torch.serve import MatchingService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MatchingService({})


def test_load_matcher_default_device_needs_cuda(monkeypatch):
    from loftr_tpu_torch.api import load_matcher
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_matcher()


def test_load_matcher_cpu_is_seeded():
    from loftr_tpu_torch.api import load_matcher
    a = load_matcher(seed=3, device="cpu").state_dict()
    b = load_matcher(seed=3, device="cpu").state_dict()
    c = load_matcher(seed=4, device="cpu").state_dict()
    k = "loftr_coarse.layers.0.q_proj.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])


def test_derived_weights_follow_parameter_changes():
    from loftr_tpu_torch.models.transformer import apply_linear
    lin = torch.nn.Linear(4, 3)
    x = torch.ones(2, 4, dtype=torch.bfloat16)
    with torch.no_grad():
        a = apply_linear(lin, x)
        assert torch.equal(apply_linear(lin, x), a)
        cached = lin._derived_cache[torch.bfloat16][1][0]
        assert apply_linear(lin, x) is not None
        assert lin._derived_cache[torch.bfloat16][1][0] is cached  # reused
        lin.load_state_dict({"weight": torch.zeros(3, 4),
                             "bias": torch.zeros(3)})
        assert torch.equal(apply_linear(lin, x), torch.zeros(2, 3).bfloat16())
    out = apply_linear(lin, x)           # autograd on: no cached tensor
    assert out.requires_grad
