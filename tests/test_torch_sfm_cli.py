"""PyTorch port: ``python -m loftr_tpu_torch.sfm``, the profiler, the demo
and the examples, on the CPU (``--device cpu``), on a tiny ScanNet-layout
sequence written by ``data/synthetic.write_scannet_sequence`` (6 frames at
160x120), with the ``indoor_ds`` preset at its published widths and seeded
random weights (an untrained net finds few or no matches, so the sequence
may give no edges: the report's keys and files are what is checked).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from loftr_tpu_torch.data.io import read_scannet_depth, read_scannet_pose
from loftr_tpu_torch.data.synthetic import write_scannet_sequence
from loftr_tpu_torch.sfm import cli
from loftr_tpu_torch.utils import profiler as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the report keys of the JAX package's sfm.py
SFM_KEYS = {"scene", "n_frames", "n_keyframes", "n_edges", "ba_cost"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet") / "scene0001_00"
    K = write_scannet_sequence(str(root), n_frames=6, size=(160, 120),
                               seed=3)
    return str(root), K


def test_scannet_writer_layout_and_readers(sequence):
    root, K = sequence
    for sub, ext in (("color", "jpg"), ("depth", "png"), ("pose", "txt")):
        assert sorted(os.listdir(os.path.join(root, sub))) == sorted(
            f"{i}.{ext}" for i in range(6))
    K4 = np.loadtxt(os.path.join(root, "intrinsic", "intrinsic_color.txt"))
    np.testing.assert_allclose(K4[:3, :3], K)
    np.testing.assert_allclose(cli.load_intrinsic(
        os.path.join(root, "intrinsic", "intrinsic_color.txt"), "x"), K)
    depth = read_scannet_depth(os.path.join(root, "depth", "2.png"))
    assert depth.shape == (120, 160) and 2.0 < depth.min() < depth.max() < 4
    c2w = np.loadtxt(os.path.join(root, "pose", "2.txt"))
    np.testing.assert_allclose(
        read_scannet_pose(os.path.join(root, "pose", "2.txt")) @ c2w,
        np.eye(4), atol=1e-9)


@pytest.mark.parametrize("extra", [[], ["--no-depth", "--ba-solver", "pcg"]],
                         ids=["depth", "no_depth_pcg"])
def test_sfm_cli_report_and_npz(sequence, tmp_path, capsys, extra):
    root, _ = sequence
    out = tmp_path / "traj.npz"
    prof = tprof.build_profiler("inference")
    report = cli.main(
        ["--scene-dir", root,
         "--intrinsic", os.path.join(root, "intrinsic",
                                     "intrinsic_color.txt"),
         "--resize", "160", "120", "--keyframe-stride", "2",
         "--out", str(out), "--device", "cpu"] + extra, profiler=prof)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == report
    assert SFM_KEYS <= set(report) and "ate" in report
    assert report["n_frames"] == 6 and report["n_keyframes"] == 3
    assert np.isfinite(report["ate"]["ate_rmse"])
    traj = np.load(out)
    assert traj["keyframes"].tolist() == [0, 2, 4]
    assert traj["R"].shape == (3, 3, 3) and traj["t"].shape == (3, 3)
    times = prof.totals()
    assert times["sfm/match"]["calls"] == 3
    assert {"sfm/edges", "sfm/tracks", "sfm/problem"} <= set(times)


def test_sfm_cli_runs_on_cuda_unless_told(sequence):
    root, _ = sequence
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--scene-dir", root, "--intrinsic", "500,500,80,60",
                  "--resize", "160", "120"])


def test_sfm_cli_keeps_the_jax_flags():
    args = cli.parse_args(["--scene-dir", "s", "--intrinsic", "1,1,0,0"])
    assert (args.keyframe_stride, args.link_range, args.max_frames,
            args.ba_iters, args.ba_solver, tuple(args.resize), args.no_depth,
            args.preset, args.device) == (10, 2, 0, 15, "dense", (640, 480),
                                          False, "indoor_ds", "cuda")


def test_sfm_module_entry_point():
    out = subprocess.run([sys.executable, "-m", "loftr_tpu_torch.sfm",
                          "--help"], capture_output=True, text=True,
                         cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "--ba-solver" in out.stdout and "--device" in out.stdout


# ------------------------------------------------------------ profiler
def test_region_profiler_summary():
    prof = tprof.build_profiler("inference")
    with prof.profile("stage_a"):
        _ = torch.ones((100, 100)) @ torch.ones((100, 100))
    with prof.profile("stage_a"):
        pass
    with prof.profile("stage_b"):
        pass
    summary = prof.summary()
    assert "stage_a" in summary and "stage_b" in summary
    assert len(prof.times["stage_a"]) == 2
    assert prof.totals()["stage_a"]["calls"] == 2
    with pytest.raises(ValueError):
        tprof.build_profiler("bogus")
    off = tprof.build_profiler(None)
    with off.profile("stage_c"):
        pass
    assert not off.times


def test_trace_writes_a_chrome_trace(tmp_path):
    prof = tprof.RegionProfiler()
    with tprof.trace(str(tmp_path)):
        with prof.profile("traced_region"):
            torch.ones(64, 64).sum()
    trace = json.load(open(tmp_path / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "traced_region" in names


# ------------------------------------------------- demo and examples
def test_demo_writes_frames(sequence, tmp_path):
    from loftr_tpu_torch import demo
    root, _ = sequence
    paths = demo.main(["--input", os.path.join(root, "color"),
                       "--output", str(tmp_path / "demo"),
                       "--resize", "160", "120", "--max-frames", "3",
                       "--ref-frame", "1", "--thr", "0.0",
                       "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == ["match_00000.png",
                                                    "match_00002.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)


def test_example_match_pair(sequence, tmp_path):
    from loftr_tpu_torch.examples import match_pair
    root, _ = sequence
    out = tmp_path / "m.png"
    res = match_pair.main([os.path.join(root, "color", "0.jpg"),
                           os.path.join(root, "color", "1.jpg"),
                           "--resize", "160", "120", "--out", str(out),
                           "--device", "cpu"])
    assert set(res) == {"mkpts0", "mkpts1", "mconf"}
    assert out.stat().st_size > 0


def test_example_serve(sequence, monkeypatch):
    from loftr_tpu_torch.examples import serve
    root, _ = sequence
    monkeypatch.setattr(serve, "BUCKET", (120, 160))
    monkeypatch.setattr(serve, "BATCH_SIZES", (1, 2))
    stats = serve.main([os.path.join(root, "color"), "--device", "cpu"])
    assert stats["requests"] == 5, stats


def test_new_modules_leave_jax_out():
    code = ("import sys, loftr_tpu_torch.sfm, loftr_tpu_torch.sfm.lie, "
            "loftr_tpu_torch.sfm.ate, loftr_tpu_torch.sfm.pose_graph, "
            "loftr_tpu_torch.sfm.bundle_adjustment, "
            "loftr_tpu_torch.sfm.pipeline, loftr_tpu_torch.sfm.cli, "
            "loftr_tpu_torch.utils.profiler, loftr_tpu_torch.utils.precision, "
            "loftr_tpu_torch.demo, loftr_tpu_torch.examples.match_pair, "
            "loftr_tpu_torch.examples.serve\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', "
            "'orbax', 'loftr_tpu') or m.startswith(('jax.', 'flax.', "
            "'optax.', 'orbax.', 'loftr_tpu.'))]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
