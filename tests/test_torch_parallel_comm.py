"""PyTorch port: the collectives, the mesh and the evaluator's merge across
two gloo ranks on the CPU (``loftr_tpu_torch.parallel``).

The two ranks run once, in a module fixture, every check of this file
(``tests/torch_parallel_worker.py::comm_check``); the tests read their
records.  The evaluator merge is held to ``evaluate_batches`` in one
process on the same 4 synthetic pairs (the evaluator test's narrow model):
every key equal but for the order of the mean over pairs (rel 1e-12).
"""
import glob
import os

import numpy as np
import pytest
import torch

from loftr_tpu.parallel.comm import process_allgather_objects as jax_gather
from loftr_tpu_torch import get_config
from loftr_tpu_torch.data import DataLoader
from loftr_tpu_torch.data.megadepth import MegaDepthDataset
from loftr_tpu_torch.data.sampler import ConcatDataset
from loftr_tpu_torch.data.synthetic import make_synthetic_megadepth
from loftr_tpu_torch.eval.evaluator import Evaluator
from loftr_tpu_torch.models.matcher import LoFTR
from loftr_tpu_torch.parallel import comm
from loftr_tpu_torch.utils.weights import init_weights

from torch_parallel_worker import run_ranks

SIZE = 96
SMALL = {"loftr": {
    "backbone": {"initial_dim": 16, "block_dims": (16, 24, 32)},
    "coarse": {"d_model": 32, "nhead": 4, "layer_names": ("self", "cross")},
    "fine": {"d_model": 16, "nhead": 2, "layer_names": ("self", "cross")},
    "match_coarse": {"thr": 0.0, "max_matches": 64},
    "dtype": "float32"},
    "trainer": {"epi_err_thr": 1e-4}}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("comm")
    root = str(out / "synth")
    make_synthetic_megadepth(root, n_scenes=4, n_views=2, img_size=SIZE,
                             seed=3)
    cfg = get_config("outdoor_ds", SMALL)
    model = LoFTR(cfg.loftr)
    init_weights(model, 0)
    npz = sorted(glob.glob(os.path.join(root, "index", "*.npz")))
    torch.save({"overrides": SMALL, "state": model.state_dict(),
                "root": root, "npz": npz, "size": SIZE},
               str(out / "eval_spec.pt"))
    recs = run_ranks("comm", out, timeout=150)
    ds = ConcatDataset([MegaDepthDataset(root, n, mode="test",
                                         img_resize=SIZE, df=8,
                                         img_padding=True) for n in npz])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ev = Evaluator(cfg, model.eval(), pose_solver="native", device="cpu")
        want = ev.evaluate_batches(DataLoader(ds, batch_size=1,
                                              num_workers=0))
    finally:
        torch.set_num_threads(n)
    return recs, want


def test_allgather_objects_matches_jax_contract(run):
    """Every rank gets every rank's object, in rank order; one process
    gets [obj] untouched, as JAX's process_allgather_objects."""
    recs, _ = run
    for rec in recs:
        got = rec["objects"]
        assert [g["identifiers"] for g in got] == [["scene0#p0"],
                                                   ["scene1#p0", "scene1#p1"]]
        np.testing.assert_array_equal(got[1]["epi_errs"][0], np.arange(3.0))
    obj = {"a": [1]}
    assert comm.process_allgather_objects(obj)[0] is obj
    assert jax_gather(obj)[0] is obj


def test_all_reduce_sum_carries_the_gradient(run):
    """y = x0^2 + x1^2 with rank r's loss part (r + 1) y: every rank's
    dL/dx_r = 2 x_r * (1 + 2)."""
    recs, _ = run
    for r, rec in enumerate(recs):
        y, g = rec["reduce"]
        np.testing.assert_array_equal(y.numpy(), np.full(3, 5.0))
        np.testing.assert_array_equal(g.numpy(), np.full(3, 6.0 * (r + 1)))


def test_all_gather_and_ring_shift(run):
    recs, _ = run
    want = np.concatenate([np.arange(6.0).reshape(2, 3),
                           np.arange(6.0).reshape(2, 3) + 10], axis=1)
    w = np.arange(12.0).reshape(2, 6)
    for r, rec in enumerate(recs):
        g, grad = rec["gather"]
        np.testing.assert_array_equal(g.numpy(), want)
        np.testing.assert_array_equal(grad.numpy(), w[:, 3 * r:3 * r + 3])
        s, sgrad = rec["ring"]
        np.testing.assert_array_equal(s.numpy(), np.full(2, float(1 - r)))
        # rank r's value went to rank r + 1, whose loss weighs it r + 2
        np.testing.assert_array_equal(sgrad.numpy(),
                                      np.full(2, float((r + 1) % 2 + 1)))


def test_mesh_shard_batch_and_replicate(run):
    recs, _ = run
    for r, rec in enumerate(recs):
        assert rec["mesh"] == ({"data": 2, "model": 1},
                               {"data": r, "model": 0}, 2, 1)
        np.testing.assert_array_equal(
            rec["rows"]["x"].numpy(), np.arange(8).reshape(4, 2)[2 * r:2 * r + 2])
        assert rec["rows"]["none"] is None
    a, b = (rec["replicated"] for rec in recs)
    assert set(a) == {"weight", "bias", "stat"}
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(a["stat"], torch.zeros(2))       # rank 0's buffer


def test_evaluator_merge_equals_one_process(run):
    """Two ranks evaluate their pairs of evaluate_dataset's round-robin
    split; the merged metrics equal evaluate_batches over all pairs."""
    recs, want = run
    for rec in recs:
        got = rec["eval"]
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15), k
