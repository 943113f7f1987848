"""On the card: a whole run of each cell is correct, and the control (the
reference in fp8 in the port's place) fails the same comparison.  Skips
without CUDA; on the card run with

    python3 -m pytest -o addopts="" bench_port/tests/test_bench_chip.py

(one process: the runs take the card one at a time)."""
import json
import os
import subprocess
import sys

import pytest

from bench_port import core

ROOT = os.path.dirname(core.HERE)
CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none here")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell):
    _need_card()
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 77), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_comparison(cell):
    _need_card()
    import torch
    from bench_port import control
    c = core.load_cell(cell)
    dev = torch.device("cuda", 0)
    rec = (control.train_control(c, 31, dev) if c.mix["generator"] == "train"
           else control.match_control(c, 31, dev))
    for name in ("control",) + (("half_batch",) if "half_batch" in rec
                                else ()):
        failed = [k for k, lim in c.limits.items() if rec[name][k] > lim]
        assert failed, (name, rec[name])
