"""PyTorch port: the training CLI (``python -m loftr_tpu_torch.train``)
against the JAX package's top-level ``train.py``.

The parser flag by flag; the datasets, sampler and loader batch by batch
(pair indices and bit-equal arrays); the derived trainer config (steps per
epoch, accumulation, scaled LR and warm-up, schedule), captured from both
``main`` functions where they build their ``Trainer``; and a 4-step CPU
run at tiny widths that writes the log, the val records, figures, a dump
and a checkpoint, on JAX's sample order.
"""
import argparse
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import train as jax_train  # noqa: E402  (the JAX package's train.py)
import loftr_tpu.data as jd  # noqa: E402
from loftr_tpu.config import get_config_from_files as jax_config_from_files  # noqa: E402
from loftr_tpu_torch.config import get_config_from_files  # noqa: E402
from loftr_tpu_torch.data import DataLoader, SceneBalancedSampler  # noqa: E402
from loftr_tpu_torch.data.synthetic import make_synthetic_megadepth  # noqa: E402
from loftr_tpu_torch.train import cli  # noqa: E402

SIZE = 96
TINY = {"loftr": {
    "backbone": {"initial_dim": 16, "block_dims": [16, 24, 32]},
    "coarse": {"d_model": 32, "nhead": 4, "layer_names": ["self", "cross"]},
    "fine": {"d_model": 16, "nhead": 2, "layer_names": ["self", "cross"]},
    "match_coarse": {"train_pad_num_gt_min": 8}}}
REQUIRED = ["--data-root", "a", "--npz-root", "b", "--list-path", "c"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes on a few
    cores, where each process's full thread pool would oversubscribe them
    (this module's many small CPU steps slowed 10-30x that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_parser(monkeypatch):
    """The argparse parser of the JAX train.py (it parses sys.argv)."""
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        return orig(self, REQUIRED)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    jax_train.parse_args()
    monkeypatch.undo()
    return seen["parser"]


def _actions(parser):
    return {a.option_strings[0]: a for a in parser._actions
            if a.option_strings and a.dest != "help"}


def _port_parser(monkeypatch):
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        return orig(self, args, namespace)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    cli.parse_args(REQUIRED)
    monkeypatch.undo()
    return seen["parser"]


JAX_FLAGS = sorted(_actions(_jax_parser(pytest.MonkeyPatch())))


@pytest.mark.parametrize("flag", JAX_FLAGS)
def test_parser_flag_matches_jax(flag, monkeypatch):
    j = _actions(_jax_parser(monkeypatch))[flag]
    t = _actions(_port_parser(monkeypatch))[flag]
    assert t.option_strings == j.option_strings
    assert (t.dest, t.required, t.type, t.nargs, t.const) == (
        j.dest, j.required, j.type, j.nargs, j.const)
    assert type(t) is type(j)
    if flag == "--val-pose-solver":
        # the port's solvers; batched is its counterpart of JAX's "jax"
        assert (j.default, t.default) == ("jax", "batched")
        assert "opencv" in t.choices and "batched" in t.choices
    else:
        assert t.default == j.default
        assert t.choices == j.choices


def test_parser_adds_only_device(monkeypatch):
    extra = set(_actions(_port_parser(monkeypatch))) - set(JAX_FLAGS)
    assert extra == {"--device"}
    assert cli.parse_args(REQUIRED).device == "cuda"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    make_synthetic_megadepth(root, n_scenes=2, n_views=3, img_size=SIZE,
                             seed=1)
    val = os.path.join(root, "val")
    make_synthetic_megadepth(val, n_scenes=1, n_views=3, img_size=SIZE,
                             seed=9, scene_prefix="val")
    return root


def _args(root, *extra):
    """CLI arguments on the synthetic set; preset outdoor_ds unless
    ``extra`` names one."""
    preset = [] if "--preset" in extra else ["--preset", "outdoor_ds"]
    return preset + [
        "--dataset", "megadepth", "--data-root", root,
        "--npz-root", os.path.join(root, "index"),
        "--list-path", os.path.join(root, "index", "scene_list.txt"),
        "--img-resize", str(SIZE), "--num-workers", "2", *extra]


def _jax_namespace(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    ns = jax_train.parse_args()
    monkeypatch.undo()
    return ns


def _batches(loader, n):
    out = []
    for i, (inp, meta) in enumerate(loader):
        if i == n:
            break
        out.append((inp, meta))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_datasets_sampler_loader_match_jax(data, monkeypatch):
    argv = _args(data)
    targs = cli.parse_args(argv)
    jargs = _jax_namespace(argv, monkeypatch)
    tcfg = get_config_from_files(preset="outdoor_ds")
    jcfg = jax_config_from_files(preset="outdoor_ds")
    tds = cli.build_datasets(targs, tcfg, 1, 0)
    jds = jax_train.build_datasets(jargs, jcfg, 1, 0)
    assert len(tds) == len(jds) == 6
    ts = SceneBalancedSampler(tds, 3, seed=tcfg.trainer.seed)
    js = jd.SceneBalancedSampler(jds, 3, seed=jcfg.trainer.seed)
    tb = _batches(DataLoader(tds, 2, ts, num_workers=2), 3)
    jb = _batches(jd.DataLoader(jds, 2, js, num_workers=2), 3)
    assert len(tb) == len(jb) == 3
    for (ti, tm), (ji, jm) in zip(tb, jb):
        assert [(m["scene_id"], m["pair_id"]) for m in tm] == \
            [(m["scene_id"], m["pair_id"]) for m in jm]
        for k in ("image0", "image1", "depth0", "depth1", "mask0", "mask1",
                  "K0", "K1", "T_0to1", "T_1to0", "scale0", "scale1"):
            a, b = _np(getattr(ti, k)), _np(getattr(ji, k))
            assert a.dtype == b.dtype and np.array_equal(a, b), k


class _Captured(Exception):
    pass


def _capture_trainer(monkeypatch, module):
    def stub(cfg, world_size=1, batch_size_per_device=1, **kw):
        raise _Captured(cfg, world_size, batch_size_per_device)
    monkeypatch.setattr(module, "Trainer", stub)


@pytest.mark.parametrize("extra", [
    ["--batch-size", "2", "--n-samples-per-subset", "3"],
    ["--accum-steps", "2", "--steps-per-epoch", "7", "--seed", "5"],
    ["--batch-size", "3", "--accum-steps", "3", "--preset", "indoor_ds",
     "--config-json", '{"trainer": {"warmup_step": 90, '
     '"scheduler_interval": "step", "scheduler": "CosineAnnealing"}}'],
], ids=["batch", "accum_steps_per_epoch", "config_json"])
def test_derived_trainer_config_matches_jax(data, extra, monkeypatch):
    import loftr_tpu.train.trainer as jt
    import loftr_tpu_torch.train.trainer as tt
    from loftr_tpu.train.trainer import Trainer as JaxTrainer
    argv = _args(data, *extra)
    # JAX's main on one device (the tests' JAX platform has eight)
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    _capture_trainer(monkeypatch, jt)
    with pytest.raises(_Captured) as je:
        jax_train.main()
    _capture_trainer(monkeypatch, tt)
    with pytest.raises(_Captured) as te:
        cli.main(argv + ["--device", "cpu"])
    monkeypatch.undo()
    jcfg, jws, jbs = je.value.args
    tcfg, tws, tbs = te.value.args
    assert (tws, tbs) == (jws, jbs) == (1, int(cli.parse_args(argv)
                                                .batch_size))
    for k in ("steps_per_epoch", "seed", "accum_steps", "warmup_step",
              "canonical_lr", "canonical_bs", "scheduler",
              "scheduler_interval"):
        assert getattr(tcfg.trainer, k) == getattr(jcfg.trainer, k), k
    trainer = tt.Trainer(tcfg, world_size=tws, batch_size_per_device=tbs,
                         device="cpu")
    jtrainer = JaxTrainer(jcfg, world_size=jws, batch_size_per_device=jbs)
    assert (trainer.true_lr, trainer.warmup_step) == \
        jcfg.scaled_lr(jws, jbs)
    for s in (0, 1, 7, 29, trainer.warmup_step - 1, trainer.warmup_step,
              trainer.warmup_step + 40):
        # JAX's schedule evaluates in float32, the port's in float64
        assert trainer._lr_sched(s) == pytest.approx(
            float(jtrainer._lr_sched(s)), rel=1e-6,
            abs=1e-6 * trainer.true_lr), s


def test_cli_runs_logs_validates_and_checkpoints(data, tmp_path,
                                                 monkeypatch):
    """4 steps (2 scenes x 2 samples, batch 1) on JAX's sample order (one
    sampler draw before the loop, as JAX's example batch takes it), then
    validation with the batched solver, a figure and a dump."""
    import loftr_tpu_torch.train.trainer as tt
    seen = []
    orig = tt.Trainer.train_step

    def record(self, state, batch, noise=None):
        seen.append(batch.image0.numpy().copy())
        return orig(self, state, batch, noise)

    monkeypatch.setattr(tt.Trainer, "train_step", record)
    ck = str(tmp_path / "ck")
    val = os.path.join(data, "val")
    state = cli.main(_args(
        data, "--n-samples-per-subset", "2",
        "--max-epochs", "1", "--log-every", "1", "--ckpt-dir", ck,
        "--val-npz-path", os.path.join(val, "index", "val_0000.npz"),
        "--val-data-root", val, "--val-figures", "1", "--val-dump",
        "--config-json", json.dumps(TINY), "--device", "cpu"))
    assert state.step == 4
    recs = [json.loads(ln) for ln in open(
        os.path.join(ck, "logs", "metrics.jsonl"))]
    train_recs = [r for r in recs if "phase" not in r]
    assert [r["step"] for r in train_recs] == [1, 2, 3, 4]
    for r in train_recs:
        assert set(r) == {"step", "time", "loss", "loss_c", "loss_f",
                          "grad_norm", "lr", "epoch"}
        assert np.isfinite(r["loss"])
    (v,) = [r for r in recs if r.get("phase") == "val"]
    assert set(v) == {"step", "time", "epoch", "phase", "auc@5", "auc@10",
                      "auc@20", "prec@5e-04"} and v["step"] == 4
    assert os.listdir(os.path.join(ck, "logs", "figures")) == [
        "val_step00000004_0.png"]
    assert os.path.isfile(os.path.join(ck, "logs", "val_dump_e0_r0.npz"))
    index = json.load(open(os.path.join(ck, "checkpoints.json")))
    assert index == {"4": v["auc@10"]}
    assert os.path.isfile(os.path.join(ck, "step_00000004.pt"))

    # JAX's pipeline: its sampler after the example batch's draw
    jargs = _jax_namespace(_args(data), monkeypatch)
    jcfg = jax_config_from_files(preset="outdoor_ds")
    jds = jax_train.build_datasets(jargs, jcfg, 1, 0)
    js = jd.SceneBalancedSampler(jds, 2, seed=jcfg.trainer.seed)
    iter(js)
    jb = _batches(jd.DataLoader(jds, 1, js, num_workers=2), 4)
    assert len(seen) == 4
    for a, (ji, _) in zip(seen, jb):
        assert np.array_equal(a, np.asarray(ji.image0))


def test_cli_without_cuda_raises(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_args(data, "--ckpt-dir", str(tmp_path)))


def test_module_entry_point_help():
    out = subprocess.run(
        [sys.executable, "-m", "loftr_tpu_torch.train", "--help"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    for flag in JAX_FLAGS + ["--device"]:
        assert flag in out.stdout, flag
