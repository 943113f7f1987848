"""PyTorch port: the training CLI under two gloo ranks on the CPU, the
counterpart of ``tests/test_multiprocess.py``.

Each rank is a process with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``; the store a ``file://`` path in
``LOFTR_INIT_METHOD`` instead of a TCP port) that runs
``loftr_tpu_torch.train.cli.main`` with ``--device cpu`` on two synthetic
MegaDepth scenes at 96 px and tiny widths: one epoch of 2 steps a rank
(one scene each, batch 1) and a validation with the ``native`` solver
merged across the ranks.  The ranks get separate ``--ckpt-dir``s so that
what each writes shows: rank 0 logs, validates and checkpoints, rank 1
writes nothing.  The scene shards are disjoint and cover the list, and
both ranks end with equal parameters and BatchNorm statistics.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from loftr_tpu_torch.data.synthetic import make_synthetic_megadepth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 96
TINY = {"loftr": {
    "backbone": {"initial_dim": 16, "block_dims": [16, 24, 32]},
    "coarse": {"d_model": 32, "nhead": 4, "layer_names": ["self", "cross"]},
    "fine": {"d_model": 16, "nhead": 2, "layer_names": ["self", "cross"]},
    "match_coarse": {"train_pad_num_gt_min": 8}}}
RANK_MAIN = (
    "import sys, torch\n"
    "torch.set_num_threads(1)\n"
    "from loftr_tpu_torch.train import cli\n"
    "state = cli.main(sys.argv[2:])\n"
    "torch.save({'step': state.step, 'sd': state.module.state_dict()},"
    " sys.argv[1])\n")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "synth")
    make_synthetic_megadepth(root, n_scenes=2, n_views=3, img_size=SIZE,
                             seed=1)
    val = os.path.join(root, "val")
    make_synthetic_megadepth(val, n_scenes=1, n_views=3, img_size=SIZE,
                             seed=9, scene_prefix="val")
    idx = os.path.join(root, "index")
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   LOFTR_INIT_METHOD="file://" + str(tmp / "store"))
        argv = ["--preset", "outdoor_ds", "--dataset", "megadepth",
                "--data-root", root, "--npz-root", idx,
                "--list-path", os.path.join(idx, "scene_list.txt"),
                "--img-resize", str(SIZE), "--num-workers", "0",
                "--n-samples-per-subset", "2", "--max-epochs", "1",
                "--log-every", "1", "--ckpt-dir", str(tmp / f"ck{r}"),
                "--val-npz-path", os.path.join(val, "index",
                                               "val_0000.npz"),
                "--val-data-root", val, "--val-pose-solver", "native",
                "--val-figures", "0", "--config-json", json.dumps(TINY),
                "--device", "cpu"]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN, str(tmp / f"state{r}.pt")]
            + argv, env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=150)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the CLI ranks ran past 150 s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-6000:]}"
    states = [torch.load(str(tmp / f"state{r}.pt"), weights_only=False)
              for r in range(2)]
    scenes = open(os.path.join(idx, "scene_list.txt")).read().split()
    return dict(tmp=tmp, outs=outs, states=states, scenes=scenes)


def _shard(out, r):
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith(f"rank {r} of 2: scenes ")]
    return line.split("scenes ", 1)[1].split()


def test_scene_shards_are_disjoint_and_cover_the_list(run):
    a, b = (_shard(out, r) for r, out in enumerate(run["outs"]))
    assert a and b and not set(a) & set(b)
    assert sorted(a + b) == sorted(run["scenes"])


def test_only_rank0_writes(run):
    ck0, ck1 = run["tmp"] / "ck0", run["tmp"] / "ck1"
    written = [os.path.join(d, f) for d, _, fs in os.walk(ck1) for f in fs]
    assert written == []
    recs = [json.loads(ln) for ln in open(ck0 / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in recs if "phase" not in r] == [1, 2]
    (v,) = [r for r in recs if r.get("phase") == "val"]
    assert {"auc@5", "auc@10", "auc@20"} <= set(v)
    assert json.load(open(ck0 / "checkpoints.json")) == {"2": v["auc@10"]}
    assert (ck0 / "step_00000002.pt").is_file()


def test_ranks_end_with_equal_parameters(run):
    a, b = run["states"]
    assert a["step"] == b["step"] == 2
    assert set(a["sd"]) == set(b["sd"])
    for k, v in a["sd"].items():
        assert torch.equal(v, b["sd"][k]), k
