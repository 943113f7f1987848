"""PyTorch port: the synthetic accuracy benchmark and its seed sweep
(``loftr_tpu_torch.tools``) against the JAX package's ``tools/``.

``generate_data`` writes the JAX tool's scenes (image bytes, depth arrays,
poses, intrinsics, pair lists); the parsers keep the JAX flags and
defaults; a shortened CPU run (2 train scenes and 1 held-out scene of 4
views at 128 px, 24 steps) trains, runs the port's eval CLI in a
subprocess with ``--device cpu`` and returns the JAX artifact's keys, with
the eval dump and figures written; the sweep's per-arm statistics equal
the JAX sweep's over the same per-seed results.
"""
import argparse
import json
import os
import sys

import h5py
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import tools.seed_sweep as jax_sweep  # noqa: E402
import tools.synthetic_benchmark as jax_bench  # noqa: E402
from loftr_tpu_torch.tools import seed_sweep as sweep  # noqa: E402
from loftr_tpu_torch.tools import synthetic_benchmark as bench  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes on a few
    cores, where each process's full thread pool would oversubscribe them
    (this module's many small CPU steps slowed 10-30x that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene_files(root, npz):
    info = np.load(npz, allow_pickle=True)
    return info, [os.path.join(root, p) for p in info["image_paths"]], \
        [os.path.join(root, p) for p in info["depth_paths"]]


def _depth(path):
    if path.endswith(".npy"):
        return np.load(path)
    with h5py.File(path, "r") as f:
        return f["depth"][()]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    out = {}
    for name, mod, fmt in (("jax", jax_bench, None), ("h5", bench, "h5"),
                           ("npy", bench, "npy")):
        root = str(tmp_path_factory.mktemp(name))
        kw = {} if fmt is None else {"depth_format": fmt}
        tr, test_idx = mod.generate_data(root, 1, 1, 3, 64, seed=4,
                                         baseline=0.6, **kw)
        out[name] = (root, tr + [os.path.join(test_idx, "test_0000.npz")])
    return out


@pytest.mark.parametrize("fmt", ["h5", "npy"])
def test_generate_data_matches_jax(scenes, fmt):
    jroot, jnpzs = scenes["jax"]
    troot, tnpzs = scenes[fmt]
    assert [os.path.relpath(p, troot) for p in tnpzs] == \
        [os.path.relpath(p, jroot) for p in jnpzs] == [
            "index/train_0000.npz", "index_test/test_0000.npz"]
    for jn, tn in zip(jnpzs, tnpzs):
        ji, jimgs, jdeps = _scene_files(jroot, jn)
        ti, timgs, tdeps = _scene_files(troot, tn)
        assert list(ti["image_paths"]) == list(ji["image_paths"])
        for k in ("intrinsics", "poses"):
            assert np.array_equal(ti[k], ji[k]), k
        assert [tuple(p[0]) + tuple(p[1:]) for p in ti["pair_infos"]] == \
            [tuple(p[0]) + tuple(p[1:]) for p in ji["pair_infos"]]
        for a, b in zip(timgs, jimgs):
            assert open(a, "rb").read() == open(b, "rb").read()
        for a, b in zip(tdeps, jdeps):
            assert a.endswith("." + fmt)
            assert np.array_equal(_depth(a), _depth(b))


class _Stop(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The argparse parser a main() builds (stopped at parse_args)."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Stop):
        main()
    monkeypatch.undo()
    return {a.option_strings[0]: a for a in seen["parser"]._actions
            if a.option_strings and a.dest != "help"}


TOOLS = {"synthetic_benchmark": (jax_bench, bench, {"--cpu"},
                                 {"--device", "--depth-format"}),
         "seed_sweep": (jax_sweep, sweep, set(),
                        {"--eval-untrained", "--device", "--depth-format",
                         "--deterministic", "--init-seeds"})}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_parser_keeps_jax_flags_and_defaults(tool, monkeypatch):
    jmod, tmod, dropped, added = TOOLS[tool]
    j = _parser_of(jmod.main, monkeypatch)
    t = _parser_of(tmod.main, monkeypatch)
    assert set(t) == (set(j) - dropped) | added
    for flag in set(j) - dropped:
        ja, ta = j[flag], t[flag]
        assert (ta.dest, ta.type, ta.nargs, ta.choices, type(ta)) == (
            ja.dest, ja.type, ja.nargs, ja.choices, type(ja)), flag
        if flag == "--work-dir":  # under the temporary directory
            assert os.path.basename(ta.default) == \
                os.path.basename(ja.default)
        else:
            assert ta.default == ja.default, flag


def test_short_cpu_run_returns_jax_artifact_keys(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the eval subprocesses
    work = str(tmp_path / "work")
    out = str(tmp_path / "artifact.json")
    art = bench.main([
        "--work-dir", work, "--img-size", "128", "--img-resize", "128",
        "--train-scenes", "2", "--test-scenes", "1", "--views", "4",
        "--steps", "24", "--batch", "2", "--device", "cpu",
        "--eval-untrained", "--out", out])
    assert json.load(open(out)) == json.loads(json.dumps(art))
    jax_art = json.load(open(os.path.join(REPO, "perf",
                                          "synthetic_auc.json")))
    assert list(art) == list(jax_art)
    assert set(art["config"]) == (set(jax_art["config"]) - {"cpu"}) | {
        "device", "depth_format"}
    assert list(art["results"]) == ["untrained", "trained"]
    for res in art["results"].values():
        assert set(res) == set(jax_art["results"]["trained"])
        assert all(np.isfinite(v) for v in res.values())
    assert len(art["train_loss_curve_per20"]) == 2
    assert np.isfinite(art["train_loss_last20"])
    assert os.path.isfile(os.path.join(work, "eval_dump.npz"))
    assert len(os.listdir(os.path.join(work, "figures"))) == 4


def _fake_results(seeds, arms):
    rng = np.random.RandomState(0)
    return {(s, a): {m: float(rng.rand()) for m in jax_sweep.METRICS}
            for s in seeds for a in arms}


def _fakes(results):
    def generate_data(wd, *a, **k):
        return [], os.path.join(wd, "index_test")

    def train(wd, npzs, img_size, img_resize, steps, batch, lr, seed,
              train_sampling="per_pair", **k):
        losses = list(np.linspace(4.0, 0.1, steps))
        return f"{seed}|{train_sampling}", losses

    def evaluate_cli(wd, test_idx, ckpt, *a, **k):
        seed, arm = ckpt.split("|")
        return dict(results[(int(seed), arm)])

    return generate_data, train, evaluate_cli


@pytest.mark.parametrize("arms", [["per_pair", "global_replacement"],
                                  ["per_pair"]])
def test_seed_sweep_statistics_match_jax(tmp_path, monkeypatch, arms):
    seeds = [0, 1]
    results = _fake_results(seeds, arms)
    gen, tr, ev = _fakes(results)
    common = ["--seeds", "0", "1", "--arms", *arms, "--steps", "60"]
    for name, fn in (("generate_data", gen), ("train", tr),
                     ("evaluate_cli", ev)):
        monkeypatch.setattr(jax_bench, name, fn)
        monkeypatch.setattr(sweep, name, fn)
    monkeypatch.setattr(sweep, "live_cells", lambda *a: {"pairs": 0})
    monkeypatch.setattr(sys, "argv", [
        "seed_sweep.py", *common, "--work-dir", str(tmp_path / "j"),
        "--out", str(tmp_path / "jax.json")])
    jax_sweep.main()
    want = json.load(open(tmp_path / "jax.json"))
    got = sweep.main([*common, "--work-dir", str(tmp_path / "t"),
                      "--device", "cpu", "--out", str(tmp_path / "t.json")])
    assert json.loads(json.dumps(got["summary"])) == want["summary"]
    assert set(got["summary"]) == set(want["summary"])
    for g, w in zip(got["runs"], want["runs"]):
        assert {k: g[k] for k in w} == w
    assert got["card"]["device"] == "cpu"
    assert set(got["card"]["tf32"]) == {"cuda.matmul.allow_tf32",
                                        "cudnn.allow_tf32"}
    assert all(set(g["tf32_eval"]) == set(jax_sweep.METRICS)
               for g in got["runs"])


def test_seed_sweep_deterministic_is_scoped(tmp_path, monkeypatch):
    """--deterministic trains under PyTorch's deterministic algorithms and
    gives the previous settings back when the sweep returns."""
    results = _fake_results([2], ["per_pair"])
    gen, tr, ev = _fakes(results)
    seen = []

    def train(*a, **k):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.deterministic,
                     os.environ.get("CUBLAS_WORKSPACE_CONFIG")))
        return tr(*a, **k)

    for name, fn in (("generate_data", gen), ("train", train),
                     ("evaluate_cli", ev)):
        monkeypatch.setattr(sweep, name, fn)
    monkeypatch.setattr(sweep, "live_cells", lambda *a: {"pairs": 0})
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic)
    got = sweep.main(["--seeds", "2", "2", "--arms", "per_pair", "--steps",
                      "60", "--deterministic", "--device", "cpu",
                      "--work-dir", str(tmp_path), "--out",
                      str(tmp_path / "d.json")])
    assert seen == [(True, True, ":4096:8")] * 2
    assert [r["init_seed"] for r in got["runs"]] == [2, 2]
    assert got["config"]["deterministic"] is True
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.backends.cudnn.deterministic) == before
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ


def test_seed_sweep_init_seeds(tmp_path, monkeypatch):
    """--init-seeds trains one scene set from other initial weights."""
    results = _fake_results([2], ["per_pair"])
    gen, tr, ev = _fakes(results)
    seen = []

    def train(*a, **k):
        seen.append((a[7], k["init_seed"]))
        return tr(*a, **k)

    for name, fn in (("generate_data", gen), ("train", train),
                     ("evaluate_cli", ev)):
        monkeypatch.setattr(sweep, name, fn)
    monkeypatch.setattr(sweep, "live_cells", lambda *a: {"pairs": 0})
    common = ["--seeds", "2", "2", "--arms", "per_pair", "--steps", "60",
              "--device", "cpu", "--work-dir", str(tmp_path), "--out",
              str(tmp_path / "i.json")]
    got = sweep.main(common + ["--init-seeds", "5", "6"])
    assert seen == [(2, 5), (2, 6)]
    assert [(r["seed"], r["init_seed"]) for r in got["runs"]] == [(2, 5),
                                                                 (2, 6)]
    with pytest.raises(ValueError):
        sweep.main(common + ["--init-seeds", "5"])


@pytest.mark.parametrize("tf32", [False, True])
def test_evaluate_cli_float32_unless_asked(monkeypatch, tmp_path, tf32):
    """The eval child runs with TF32 off (a float32 evaluation, as the JAX
    tool's on the CPU) unless the caller asks for PyTorch's defaults."""
    seen = {}

    class Done:
        returncode, stderr = 0, ""
        stdout = json.dumps({m: 0.5 for m in jax_sweep.METRICS})

    def run(cmd, env=None, **k):
        seen["cmd"], seen["env"] = cmd, env
        return Done()

    monkeypatch.setattr(bench.subprocess, "run", run)
    monkeypatch.delenv("NVIDIA_TF32_OVERRIDE", raising=False)
    got = bench.evaluate_cli(str(tmp_path), "idx", "ckpt", 256,
                             device="cpu", tf32=tf32)
    assert got == {m: 0.5 for m in jax_sweep.METRICS}
    assert seen["cmd"][1:3] == ["-m", "loftr_tpu_torch.test"]
    assert seen["env"].get("NVIDIA_TF32_OVERRIDE") == (None if tf32
                                                       else "0")
