"""On the card: a whole run of each cell this file names is correct, the
OT cell's window runs kernel E once a forward and kernel B never, and its
control and planted faults (``control_ot.py``) each fail the cell's own
limits.
Skips without CUDA; on the card run with

    python3 -m pytest -o addopts="" bench_port/tests/test_bench_ot_chip.py

(one process: the runs take the card one at a time)."""
import json
import os
import subprocess
import sys

import pytest

from bench_port import core

ROOT = os.path.dirname(core.HERE)
CELLS = ["outdoor_ot.match_ot_b4"]


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none here")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_of_the_new_cell_is_correct(cell):
    _need_card()
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 91), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
def test_the_ot_window_runs_kernel_e_once_a_forward():
    _need_card()
    import torch
    from loftr_tpu_torch.ops.kernels import launch_counts
    from bench_port.generators.offline_ot import OfflineOT
    drv = OfflineOT(core.load_cell("outdoor_ot.match_ot_b4"), 2 ** 31 + 92,
                    torch.device("cuda", 0))
    drv.setup()
    before = launch_counts()
    drv.window(2.0)
    got = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
    drv.free()
    assert drv.launched > 0
    assert got["sinkhorn"] == drv.launched
    assert got["dual_softmax"] == 0
    assert got["coarse_layer"] == 12 * drv.launched
    assert got["fine_stage"] == drv.launched


@pytest.mark.cuda
def test_the_ot_control_and_planted_faults_fail_the_cells_limits():
    _need_card()
    import torch
    from bench_port import control_ot
    cell = core.load_cell("outdoor_ot.match_ot_b4")
    dev, seed = torch.device("cuda", 0), 2 ** 31 + 93
    rec = control_ot.match_control_ot(cell, seed, dev)
    prog = control_ot.program_readings(cell, seed, dev)
    got = {"control": rec["control"], **rec["faults"],
           "program_iters_2": control_ot.program_fault(cell, seed, dev),
           "random_1pct": prog["moved"]["random_1pct"]}
    checks = lambda r: [core.Check(k, float(r[k]), v)
                        for k, v in cell.limits.items()]
    assert all(c.ok for c in checks(prog["program"])), prog["program"]
    for name, r in got.items():
        assert not all(c.ok for c in checks(r)), (name, r)
