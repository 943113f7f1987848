"""PyTorch port: the training CLI's checkpoints and validation on the CPU.

``--resume`` continues bit for bit: 2 steps, a resume and 2 more end with
the parameters, running statistics, optimizer state and selection
generator of a straight 4-step run.  The set has one pair: after a resume
the epoch loop and the sampler start again at their first draw (the JAX
package's loop semantics, kept), so with several pairs the resumed steps
would train on other batches; the pair's batches are the same either way
and the comparison reads the trainer's state alone.  A SIGTERM mid-epoch
leaves a checkpoint that ``--resume`` continues from, and the signal
handlers are restored afterwards.  Validation through the ``Evaluator``
leaves BatchNorm's running statistics and the gradients untouched; it
runs the module in eval mode and leaves it in the mode it had.  A loader
abandoned mid-epoch (the preemption exit) leaves no thread behind.
"""
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from loftr_tpu_torch.config import get_config
from loftr_tpu_torch.data import DataLoader, MegaDepthDataset
from loftr_tpu_torch.data.synthetic import write_megadepth_scene
from loftr_tpu_torch.eval.evaluator import Evaluator
from loftr_tpu_torch.train import cli
from loftr_tpu_torch.train.trainer import Trainer

SIZE = 96
TINY = {"loftr": {
    "backbone": {"initial_dim": 16, "block_dims": [16, 24, 32]},
    "coarse": {"d_model": 32, "nhead": 4, "layer_names": ["self", "cross"]},
    "fine": {"d_model": 16, "nhead": 2, "layer_names": ["self", "cross"]},
    "match_coarse": {"train_pad_num_gt_min": 8}}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes on a few
    cores, where each process's full thread pool would oversubscribe them
    (this module's many small CPU steps slowed 10-30x that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_pair(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("one"))
    npz = write_megadepth_scene(root, "one", seed=7, n_views=2,
                                img_size=SIZE)
    with open(os.path.join(root, "index", "list.txt"), "w") as f:
        f.write("one\n")
    return root, npz


def _args(root, ckpt, *extra):
    return ["--preset", "outdoor_ds", "--dataset", "megadepth",
            "--data-root", root, "--npz-root", os.path.join(root, "index"),
            "--list-path", os.path.join(root, "index", "list.txt"),
            "--img-resize", str(SIZE), "--num-workers", "1",
            "--log-every", "1", "--ckpt-dir", ckpt,
            "--config-json", json.dumps(TINY), "--device", "cpu", *extra]


def _logged_steps(ckpt):
    return [json.loads(ln)["step"] for ln in open(
        os.path.join(ckpt, "logs", "metrics.jsonl"))]


def _assert_same_state(a, b):
    sa, sb = a.module.state_dict(), b.module.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step


def test_resume_is_bit_exact(one_pair, tmp_path, capsys):
    root, _ = one_pair
    straight = cli.main(_args(root, str(tmp_path / "a"),
                              "--n-samples-per-subset", "2",
                              "--max-epochs", "2"))
    part = str(tmp_path / "b")
    first = cli.main(_args(root, part, "--n-samples-per-subset", "2",
                           "--max-epochs", "1"))
    assert first.step == 2
    capsys.readouterr()
    resumed = cli.main(_args(root, part, "--n-samples-per-subset", "2",
                             "--max-epochs", "1", "--resume"))
    assert "resumed from step 2" in capsys.readouterr().out
    assert _logged_steps(part) == [1, 2, 3, 4]
    assert straight.step == resumed.step == 4
    _assert_same_state(straight, resumed)
    # the checkpoints of step 4 hold the same tensors
    pa, pb = (torch.load(os.path.join(d, "step_00000004.pt"),
                         weights_only=False)
              for d in (str(tmp_path / "a"), part))
    for k in pa["module"]:
        assert torch.equal(pa["module"][k], pb["module"][k]), k


def test_sigterm_mid_epoch_checkpoints_and_resumes(one_pair, tmp_path,
                                                   capsys, monkeypatch):
    root, _ = one_pair
    ck = str(tmp_path / "ck")
    calls = {"n": 0}
    orig = Trainer.train_step

    def step_then_signal(self, state, batch, noise=None):
        out = orig(self, state, batch, noise)
        calls["n"] += 1
        if calls["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setattr(Trainer, "train_step", step_then_signal)
    state = cli.main(_args(root, ck, "--n-samples-per-subset", "4",
                           "--max-epochs", "1"))
    monkeypatch.undo()
    assert signal.getsignal(signal.SIGTERM) is before
    out = capsys.readouterr().out
    assert "checkpoint at next step boundary" in out
    assert "preemption checkpoint saved" in out
    assert state.step == 2
    assert json.load(open(os.path.join(ck, "checkpoints.json"))) == {
        "2": None}
    resumed = cli.main(_args(root, ck, "--n-samples-per-subset", "4",
                             "--max-epochs", "1", "--resume"))
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.step == 6
    assert _logged_steps(ck) == [1, 2, 3, 4, 5, 6]
    assert sorted(json.load(open(os.path.join(ck, "checkpoints.json")))) \
        == ["2", "6"]


def _buffers(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if "running" in k or "num_batches" in k}


def test_validation_leaves_statistics_grads_and_mode(one_pair):
    root, npz = one_pair
    cfg = get_config("outdoor_ds", TINY).replaced(
        {"trainer": {"steps_per_epoch": 10}})
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    train_ds = MegaDepthDataset(root, npz, mode="train", img_resize=SIZE,
                                df=8, img_padding=True, depth_padding=True)
    val_ds = MegaDepthDataset(root, npz, mode="test", img_resize=SIZE, df=8,
                              img_padding=True, depth_padding=True)
    (batch, _), = list(DataLoader(train_ds, 1, num_workers=1))
    state, _ = trainer.train_step(state, batch)
    gen = torch.Generator().manual_seed(0)
    for p in state.module.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    grads = [p.grad.clone() for p in state.module.parameters()]
    stats = _buffers(state.module)
    assert any("running_mean" in k for k in stats)
    seen = []   # the module's mode at each forward
    hook = state.module.register_forward_pre_hook(
        lambda m, args: seen.append(m.training))
    ev = Evaluator(cfg, state.module, pose_solver="batched", device="cpu")
    assert state.module.training  # building leaves the caller's mode
    for i in range(2):  # the evaluator is built once and reused
        seen.clear()
        metrics = ev.evaluate_dataset(val_ds, num_workers=1)
        assert set(metrics) == {"auc@5", "auc@10", "auc@20", "prec@5e-04"}
        # evaluated in eval mode, then given back in train mode
        assert seen and not any(seen)
        assert state.module.training
        after = _buffers(state.module)
        for k in stats:
            assert torch.equal(stats[k], after[k]), k
        for g, p in zip(grads, state.module.parameters()):
            assert torch.equal(g, p.grad)
        # training goes on after validation (no inference tensors kept)
        state, sc = trainer.train_step(state, batch)
        assert np.isfinite(float(sc["loss"]))
        changed = _buffers(state.module)
        assert not all(torch.equal(stats[k], changed[k]) for k in stats)
        assert state.module.training
        stats = changed
        grads = [p.grad for p in state.module.parameters()]
        assert all(g is None for g in grads)
        for p in state.module.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        grads = [p.grad.clone() for p in state.module.parameters()]
    state.module.eval()
    ev.evaluate_dataset(val_ds, num_workers=1)
    assert not state.module.training
    hook.remove()


class _Items:
    def __len__(self):
        return 40

    def __getitem__(self, i):
        img = np.full((8, 8, 1), i, np.float32)
        return {"image0": img, "image1": img, "scene_id": "s",
                "pair_id": i}


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "loftr-loader"]


def test_abandoned_loader_leaves_no_thread():
    assert not _loader_threads()
    it = iter(DataLoader(_Items(), 1, num_workers=1, prefetch=1))
    inp, meta = next(it)
    assert float(inp.image0[0, 0, 0, 0]) == 0.0 and meta[0]["pair_id"] == 0
    time.sleep(0.2)  # the producer fills the queue and waits on it
    assert len(_loader_threads()) == 1
    it.close()       # the consumer stops mid-epoch
    deadline = time.time() + 5
    while _loader_threads() and time.time() < deadline:
        time.sleep(0.02)
    assert not _loader_threads()
