"""PyTorch port: the evaluation path end to end against the JAX package's.

A narrow model (widths of tests/test_torch_slice.py), float32, thr 0, on 4
synthetic MegaDepth pairs at 96 px; one seeded JAX init carried to the
port by ``state_dict_from_jax``.  The JAX ``Evaluator`` against the port's
with the ``native`` solver, and ``jax`` against ``batched`` (fed the
samples JAX draws): valid slots equal, matches within 1e-4 px, aggregated
AUC@{5,10,20} and precision within 1e-3.  Then ``python -m
loftr_tpu_torch.test --device cpu`` on the same set, and its refusal to
run without CUDA when ``--device cpu`` is not given.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loftr_tpu.data as jd
from loftr_tpu import LoFTR as JaxLoFTR
from loftr_tpu import get_config as jax_get_config
from loftr_tpu.eval.evaluator import Evaluator as JaxEvaluator
from loftr_tpu.eval.metrics import aggregate_metrics as jax_aggregate
import loftr_tpu_torch.data as td
from loftr_tpu_torch import LoFTR, get_config
from loftr_tpu_torch import test as cli
from loftr_tpu_torch.data.synthetic import make_synthetic_megadepth
from loftr_tpu_torch.eval import ransac as tr
from loftr_tpu_torch.eval.evaluator import Evaluator
from loftr_tpu_torch.train.checkpoint import save_params
from loftr_tpu_torch.utils.weights import state_dict_from_jax

SIZE = 96
H = 128  # RANSAC hypotheses
SMALL = {"loftr": {
    "backbone": {"initial_dim": 16, "block_dims": (16, 24, 32)},
    "coarse": {"d_model": 32, "nhead": 4, "layer_names": ("self", "cross")},
    "fine": {"d_model": 16, "nhead": 2, "layer_names": ("self", "cross")},
    "match_coarse": {"thr": 0.0, "max_matches": 64},
    "dtype": "float32"},
    "trainer": {"epi_err_thr": 1e-4}}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    make_synthetic_megadepth(root, n_scenes=4, n_views=2, img_size=SIZE,
                             seed=3)
    return root


def _datasets(mod, root):
    import glob
    import os
    return [mod.MegaDepthDataset(root, n, mode="test", img_resize=SIZE, df=8,
                                 img_padding=True)
            for n in sorted(glob.glob(os.path.join(root, "index",
                                                   "*.npz")))]


@pytest.fixture(scope="module")
def models(data_root):
    jcfg = jax_get_config("outdoor_ds", SMALL)
    batch, _ = jd.collate_matchinput([_datasets(jd, data_root)[0][0]])
    jm = JaxLoFTR(jcfg.loftr)
    variables = jm.init(jax.random.PRNGKey(0), jax.tree.map(
        lambda x: None if x is None else jnp.asarray(x), batch,
        is_leaf=lambda x: x is None))
    variables = jax.tree.map(np.asarray, dict(variables))
    tcfg = get_config("outdoor_ds", SMALL)
    model = LoFTR(tcfg.loftr)
    model.load_state_dict(state_dict_from_jax(variables))
    return jcfg, variables, tcfg, model.eval()


def _batches(mod, root):
    return list(mod.DataLoader(mod.sampler.ConcatDataset(
        _datasets(mod, root)), batch_size=2, num_workers=2, drop_last=False))


class JaxDraws:
    """Stands in for ``draw_samples``: the samples the JAX Evaluator's
    ``jax`` solver draws, key for key (PRNGKey(0), split per batch, then
    per pair)."""

    def __init__(self):
        self.rng = jax.random.PRNGKey(0)

    def __call__(self, valid, num_hypotheses, solver="8pt", generator=None):
        self.rng, sub = jax.random.split(self.rng)
        keys = jax.random.split(sub, valid.shape[0])
        logits = jnp.where(jnp.asarray(valid.numpy()), 0.0, -1e9)
        draws = jax.vmap(lambda k, lg: jax.random.categorical(
            k, lg[None, None, :], axis=-1, shape=(num_hypotheses, 8)))(
            keys, logits)
        return torch.from_numpy(np.array(draws))


def _oracle_matches(inp, K_cap=128):
    """Ground-truth correspondences of a batch (numpy MatchInput fields):
    random 3D points seen by both cameras, 0.01 px noise, no outliers.
    (tests/test_torch_ransac.py holds the solvers on outliers.  With 5-20%
    random matches here, the IRLS refit's residual outlier weight leaves
    t errors of 1-5 deg on these short baselines, where one float32
    inlier-count flip moves a pair by a few 0.01 deg, and AUC@5, which
    interpolates between sorted errors, by more than 1e-3.)"""
    rng = np.random.RandomState(0)
    K0, K1, T = (np.asarray(x) for x in (inp.K0, inp.K1, inp.T_0to1))
    B = K0.shape[0]
    pts = rng.rand(B, K_cap, 3) * [3.0, 3.0, 4.0] + [-1.5, -1.5, 2.5]
    p0 = np.einsum("bij,bkj->bki", K0, pts)
    p1 = np.einsum("bij,bkj->bki", K1, np.einsum(
        "bij,bkj->bki", T[:, :3, :3], pts) + T[:, None, :3, 3])
    p0 = p0[..., :2] / p0[..., 2:] + rng.randn(B, K_cap, 2) * 0.01
    p1 = p1[..., :2] / p1[..., 2:] + rng.randn(B, K_cap, 2) * 0.01
    return p0.astype(np.float32), p1.astype(np.float32)


def _jax_oracle(variables, inp):
    from loftr_tpu.structs import CoarseMatches, MatchResult
    p0, p1 = _oracle_matches(inp)
    B, Kc = p0.shape[:2]
    coarse = CoarseMatches(
        i_ids=jnp.zeros((B, Kc), jnp.int32),
        j_ids=jnp.zeros((B, Kc), jnp.int32), mconf=jnp.ones((B, Kc)),
        mask=jnp.ones((B, Kc), bool), gt_mask=jnp.zeros((B, Kc), bool))
    return MatchResult(coarse=coarse, mkpts0_c=jnp.asarray(p0),
                       mkpts1_c=jnp.asarray(p1), mkpts0_f=jnp.asarray(p0),
                       mkpts1_f=jnp.asarray(p1),
                       expec_f=jnp.zeros((B, Kc, 3)))


def _port_oracle(inp):
    from loftr_tpu_torch.structs import CoarseMatches, MatchResult
    p0, p1 = (torch.from_numpy(x) for x in _oracle_matches(inp))
    B, Kc = p0.shape[:2]
    coarse = CoarseMatches(
        i_ids=torch.zeros(B, Kc, dtype=torch.int32),
        j_ids=torch.zeros(B, Kc, dtype=torch.int32),
        mconf=torch.ones(B, Kc), mask=torch.ones(B, Kc, dtype=torch.bool),
        gt_mask=torch.zeros(B, Kc, dtype=torch.bool))
    return MatchResult(coarse=coarse, mkpts0_c=p0, mkpts1_c=p1,
                       mkpts0_f=p0, mkpts1_f=p1, expec_f=torch.zeros(B, Kc,
                                                                    3))


SOLVERS = [("native", "native"), ("jax", "batched")]


def _run(solvers, matcher, models, data_root, out):
    """(port aggregate, JAX aggregate, (port dumps, JAX dumps), port
    Evaluator, matcher): the network, or an oracle of ground-truth matches
    in its place on both sides."""
    jax_solver, port_solver = solvers
    jcfg, variables, tcfg, model = models
    jev = JaxEvaluator(jcfg, variables, pose_solver=jax_solver,
                       num_hypotheses=H)
    ev = Evaluator(tcfg, model, pose_solver=port_solver, num_hypotheses=H,
                   device="cpu")
    if matcher == "oracle":
        jev._fwd = _jax_oracle
        ev.model = _port_oracle
    want = jev.evaluate_batches(_batches(jd, data_root),
                                dump_path=str(out / "jax.npz"))
    mp = pytest.MonkeyPatch()
    mp.setattr(tr, "draw_samples", JaxDraws())
    try:
        got = ev.evaluate_batches(_batches(td, data_root),
                                  dump_path=str(out / "port.npz"))
    finally:
        mp.undo()
    dumps = [np.load(out / f"{n}.npz", allow_pickle=True)["records"]
             for n in ("port", "jax")]
    return got, want, dumps, ev, matcher


_RUNS = {}


def _cached_run(key, models, data_root, tmp_path_factory):
    if key not in _RUNS:
        matcher, solvers = key
        _RUNS[key] = _run(solvers, matcher, models, data_root,
                          tmp_path_factory.mktemp(matcher))
    return _RUNS[key]


@pytest.fixture(params=[(m, s) for m in ("net", "oracle") for s in SOLVERS],
                ids=lambda p: f"{p[0]}-{p[1][1]}")
def runs(request, models, data_root, tmp_path_factory):
    return _cached_run(request.param, models, data_root, tmp_path_factory)


@pytest.fixture(params=SOLVERS, ids=lambda p: p[1])
def oracle_runs(request, models, data_root, tmp_path_factory):
    return _cached_run(("oracle", request.param), models, data_root,
                       tmp_path_factory)


def test_valid_slots_and_matches_equal(models, data_root):
    """The network's valid slots equal, its matches within 1e-4 px."""
    jcfg, variables, tcfg, model = models
    jev = JaxEvaluator(jcfg, variables)
    for (ti, _), (ji, _) in zip(_batches(td, data_root),
                                _batches(jd, data_root)):
        jres = jev._fwd(variables, jax.tree.map(
            lambda x: None if x is None else jnp.asarray(x), ji,
            is_leaf=lambda x: x is None))
        with torch.inference_mode():
            tres = model(ti)
        v = np.asarray(jres.valid)
        np.testing.assert_array_equal(tres.valid.numpy(), v)
        assert v.sum() > 0
        for k in ("mkpts0_f", "mkpts1_f"):
            np.testing.assert_allclose(getattr(tres, k).numpy()[v],
                                       np.asarray(getattr(jres, k))[v],
                                       rtol=0, atol=1e-4)


def test_dumps_agree(runs):
    """Pairs with a pose estimate are dumped: the same pairs, matches
    within 1e-4 px; with the oracle every pair has one."""
    _, _, (port, jaxd), _, matcher = runs
    assert [p["identifier"] for p in port] == \
        [j["identifier"] for j in jaxd]
    assert len(port) == 4 if matcher == "oracle" else len(port) >= 1
    for p, j in zip(port, jaxd):
        assert p["pair_names"] == tuple(j["pair_names"])
        for k in ("mkpts0_f", "mkpts1_f"):
            assert p[k].shape == j[k].shape and len(p[k]) > 0
            np.testing.assert_allclose(p[k], j[k], rtol=0, atol=1e-4)
        np.testing.assert_allclose(p["mconf"], j["mconf"], rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(p["epi_errs"], j["epi_errs"],
                                   rtol=1e-3, atol=1e-9)


def test_aggregate_within_1e3(runs):
    got, want, _, ev, matcher = runs
    assert got.keys() == want.keys() == {"auc@5", "auc@10", "auc@20",
                                         "prec@1e-04"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-3, (k, got, want)
    if matcher == "oracle":
        assert got["auc@20"] > 0.9, got
    assert ev.timing["pairs"] == 4
    assert ev.timing["model_s"] > 0 and ev.timing["pose_s"] > 0


def test_oracle_pose_errors_per_pair(oracle_runs):
    """On ground-truth matches the same samples (batched) or the same
    library and seed (native) give per-pair pose errors within 0.05 deg
    of JAX's.  (On an untrained net's matches the poses are noise, and
    1e-5 px moves them anywhere.)"""
    _, _, (port, jaxd), _, _ = oracle_runs
    assert len(port) == 4
    for p, j in zip(port, jaxd):
        assert abs(p["R_err"] - j["R_err"]) < 0.05
        assert abs(p["t_err"] - j["t_err"]) < 0.05


def _cli_args(root, *extra):
    over = {"loftr": {k: v for k, v in SMALL["loftr"].items()
                      if k not in ("match_coarse", "dtype")}}
    return ["--preset", "outdoor_ds", "--dataset", "megadepth",
            "--data-root", root, "--npz-root", root + "/index",
            "--img-resize", str(SIZE), "--thr", "0", "--max-matches", "64",
            "--num-workers", "2", "--config-json", json.dumps(over), *extra]


@pytest.mark.parametrize("solver", ["batched", "opencv"])
def test_cli_on_cpu_prints_test_py_keys(data_root, solver, capsys):
    agg = cli.main(_cli_args(data_root, "--device", "cpu",
                             "--pose-solver", solver))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want_keys = jax_aggregate({"identifiers": ["a"], "R_errs": [1.0],
                               "t_errs": [1.0], "epi_errs": [np.zeros(1)]},
                              1e-4).keys()
    assert printed.keys() == want_keys and printed == agg
    assert all(np.isfinite(v) for v in printed.values())


def test_cli_needs_cuda_without_device_cpu(data_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_cli_args(data_root))


def test_cli_loads_port_checkpoint(models, data_root, tmp_path, capsys):
    """--ckpt takes a save_params file and a CheckpointManager-style
    payload; both give the evaluation of the saved weights."""
    _, _, tcfg, model = models
    path = str(tmp_path / "params.pt")
    save_params(path, model)
    torch.save({"module": model.state_dict(), "step": 3},
               str(tmp_path / "step.pt"))
    a = cli.main(_cli_args(data_root, "--device", "cpu", "--ckpt", path,
                           "--pose-solver", "native"))
    b = cli.main(_cli_args(data_root, "--device", "cpu", "--ckpt",
                           str(tmp_path / "step.pt"), "--pose-solver",
                           "native"))
    ev = Evaluator(tcfg, model, pose_solver="native", device="cpu")
    want = ev.evaluate_batches(_batches(td, data_root))
    assert a == b == want


def test_evaluate_dataset_shards_and_checks_the_group(models, data_root,
                                                     tmp_path):
    """evaluate_dataset shards pair indices exactly; one process gives
    evaluate_batches' result, also inside a process group of one rank
    (the merge across ranks: tests/test_torch_parallel_comm.py); a
    world_size other than the group's raises."""
    from torch_parallel_worker import one_rank_group
    _, _, tcfg, model = models
    ev = Evaluator(tcfg, model, pose_solver="native", device="cpu")
    ds = td.sampler.ConcatDataset(_datasets(td, data_root))
    got = ev.evaluate_dataset(ds, batch_size=2, num_workers=2)
    assert got == ev.evaluate_batches(_batches(td, data_root))
    with pytest.raises(ValueError, match="world_size 2"):
        ev.evaluate_dataset(ds, world_size=2, rank=0)
    with one_rank_group(tmp_path / "store"):
        assert ev.evaluate_dataset(ds, batch_size=2, num_workers=2) == got


def test_figure_sink_gets_the_first_pairs(models, data_root):
    import matplotlib.pyplot as plt
    _, _, tcfg, model = models
    ev = Evaluator(tcfg, model, pose_solver="native", device="cpu")
    figs = []
    ev.evaluate_batches(_batches(td, data_root), figure_sink=figs.extend,
                        n_figure_pairs=3)
    assert len(figs) == 3
    assert all(isinstance(f, plt.Figure) for f in figs)
    for f in figs:
        plt.close(f)
