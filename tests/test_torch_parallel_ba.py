"""PyTorch port: the point-sharded bundle adjustment across two gloo ranks
on the CPU (``sfm.bundle_adjustment.make_sharded_ba_iteration`` and
``bundle_adjust_sharded``) against JAX's on a two-device CPU mesh and the
port's single-process ``ba_iteration``.

The problems and bars are ``tests/test_sfm_ba.py``'s sharded cases (C = 5,
P = 64, O = 3, each rank 32 points): one dense LM iteration (old cost
rtol 1e-5, new cost 1e-4, t rtol 1e-4 / atol 1e-6, points rtol 1e-3 /
atol 1e-4), one pcg iteration with 200 CG steps (old cost 1e-5, new cost
1e-3, t rtol 1e-3 / atol 1e-5; points as dense), and a 15-iteration dense
loop from a noise-free problem to below 1e-6 of its first cost.  The two
ranks' cameras are equal bit for bit.

Against JAX's sharded iteration the port runs in float32, as JAX does.
Against the port's ``ba_iteration`` both run in float64: the scale gauge
leaves S at condition ~1e4 (``tests/test_torch_sfm_ba.py``), so two
float32 solves that sum in other orders sit up to condition x eps32 apart
(measured on the dense case: the single-process step 4.7e-6 from float64,
the sharded one 6.7e-6, JAX's sharded one 1.8e-5), above the t bar's
atol; in float64 the regrouped sums are the only difference.  The ranks
run once, in a module fixture (``tests/torch_parallel_worker.py::
ba_check``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from loftr_tpu.sfm import bundle_adjustment as J
from loftr_tpu_torch.sfm import bundle_adjustment as T

from test_torch_sfm_ba import _both, _synth_ba_problem
from torch_parallel_worker import save_spec, start_ranks, wait_ranks

CASES = {
    "dense": dict(problem=dict(C=5, P=64, O=3, noise=1e-3, pose_noise=0.02,
                               point_noise=0.05, seed=4),
                  solver="dense", cg_iters=100,
                  bars=dict(new=1e-4, t=(1e-4, 1e-6))),
    "pcg": dict(problem=dict(C=5, P=64, O=3, noise=1e-3, pose_noise=0.02,
                             point_noise=0.05, seed=13),
                solver="pcg", cg_iters=200,
                bars=dict(new=1e-3, t=(1e-3, 1e-5))),
}
LOOP = dict(problem=dict(C=5, P=64, O=3, noise=0.0, pose_noise=0.02,
                         point_noise=0.05, seed=5), solver="dense",
            max_iters=15)


def _torch_arrays(arrays):
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ba")
    handle = start_ranks("ba", out, timeout=120)
    problems = {n: _synth_ba_problem(**c["problem"])[0]
                for n, c in CASES.items()}
    loop_arrays = _synth_ba_problem(**LOOP["problem"])[0]
    spec = {n + sfx: {"arrays": _torch_arrays(problems[n]),
                      "solver": c["solver"], "cg_iters": c["cg_iters"],
                      "float64": sfx == "64"}
            for n, c in CASES.items() for sfx in ("", "64")}
    spec["loop"] = {"arrays": _torch_arrays(loop_arrays), "loop": True,
                    "solver": LOOP["solver"],
                    "max_iters": LOOP["max_iters"]}
    save_spec(spec, str(out / "ba_spec.pt"))

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    shard = NamedSharding(mesh, P("data"))
    repl = NamedSharding(mesh, P())
    jax_res, one = {}, {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, c in CASES.items():
            jp, tp = _both(problems[name])
            sharded = jp.replace(
                R=jax.device_put(jp.R, repl), t=jax.device_put(jp.t, repl),
                fix_mask=jax.device_put(jp.fix_mask, repl),
                points=jax.device_put(jp.points, shard),
                obs_uv=jax.device_put(jp.obs_uv, shard),
                obs_cam=jax.device_put(jp.obs_cam, shard),
                obs_w=jax.device_put(jp.obs_w, shard))
            step = J.make_sharded_ba_iteration(mesh, "data", c["solver"],
                                               c["cg_iters"])
            jax_res[name] = jax.jit(step)(sharded, jnp.asarray(1e-4))
            tp64 = tp.replace(**{k: getattr(tp, k).double() for k in
                                 ("R", "t", "points", "obs_uv", "obs_w")})
            one[name] = T.ba_iteration(tp64, 1e-4, solver=c["solver"],
                                       cg_iters=c["cg_iters"])
        cost0 = float(T.reprojection_cost(_both(loop_arrays)[1]))
    finally:
        torch.set_num_threads(n)
    return dict(recs=wait_ranks(handle), jax=jax_res, one=one, cost0=cost0)


def _check(got, want, bars):
    """got: (R, t, points, old, new) of the port's ranks; want: a JAX or
    port iteration's (problem, old, new)."""
    wp, wo, wn = want
    np.testing.assert_allclose(got["old"], float(wo), rtol=1e-5)
    np.testing.assert_allclose(got["new"], float(wn), rtol=bars["new"])
    rt, at = bars["t"]
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(wp.t), rtol=rt,
                               atol=at)
    np.testing.assert_allclose(got["points"].numpy(), np.asarray(wp.points),
                               rtol=1e-3, atol=1e-4)


def _gathered(run, name):
    a, b = (rec[name] for rec in run["recs"])
    return dict(a, points=torch.cat([a["points"], b["points"]]))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_iteration_matches_jax_sharded(run, name):
    _check(_gathered(run, name), run["jax"][name], CASES[name]["bars"])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_iteration_matches_one_process(run, name):
    """Both in float64 (see the module docstring)."""
    got = _gathered(run, name + "64")
    assert got["t"].dtype == torch.float64
    _check(got, run["one"][name], CASES[name]["bars"])


@pytest.mark.parametrize("name", list(CASES) + ["dense64", "pcg64", "loop"])
def test_ranks_hold_equal_cameras(run, name):
    a, b = (rec[name] for rec in run["recs"])
    assert torch.equal(a["R"], b["R"]) and torch.equal(a["t"], b["t"])
    if name != "loop":
        assert a["old"] == b["old"] and a["new"] == b["new"]


def test_sharded_loop_converges(run):
    """tests/test_sfm_ba.py::test_sharded_ba_full_loop's bar."""
    a, b = (rec["loop"] for rec in run["recs"])
    assert a["cost"] == b["cost"]
    assert a["cost"] < run["cost0"] * 1e-6, (run["cost0"], a["cost"])
