"""PyTorch port: the data-parallel training step across two gloo ranks on
the CPU against JAX's single-device step on the global batch.

``tests/test_torch_train_step.py``'s tiny model, batch (B = 2, seed
``BATCH_SEED``) and JAX init (PRNGKey(0)); each rank holds one row.  The ranks run once,
in a module fixture (``tests/torch_parallel_worker.py::train_check``): one
``Trainer(world_size=2)`` step on the fused focal-loss route and one on the
dense route, both with JAX's selection noise drawn at the global batch's
shape, and a ``global_replacement`` selection on each rank's candidates.

Bars:
  - against JAX's ``Trainer._train_step`` on the global batch (JAX's
    dense route, the port's dense route): ``tests/test_torch_train_step.
    py``'s, scalars and every parameter and running statistic, BatchNorm's
    included, with an Adam first step's rule for elements whose gradient
    has no determined sign (below 1e-3 of the tensor's largest, in the
    port's one-process gradient, which that file holds to JAX's at rtol
    1e-3): those within 2.2 learning rates;
  - against the port's one-process step on the global batch (both
    routes): the scalars within 1e-5 relative; the summed gradients within
    1e-4 of each tensor's largest entry (measured: 3.4e-5; the ranks add
    their halves of the BatchNorm means, the loss sums and the gradients
    where one process sums the batch at once, and the backbone's biases
    sum many cancelling terms); the parameters after the step within
    1e-6 relative where the gradient's sign is determined, 2.2 learning
    rates elsewhere;
  - the two ranks' parameters and statistics equal bit for bit;
  - the selection: slot for slot equal to JAX's on the global batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu import get_config as jax_get_config
from loftr_tpu.ops import matching as JM
from loftr_tpu.train.trainer import Trainer as JaxTrainer
from loftr_tpu_torch import get_config
from loftr_tpu_torch.train.trainer import Trainer
from loftr_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_train_step import (BATCH_SEED, TRAINER, _assert_scalars,
                                   _assert_state, _cfg, _variables)
from test_torch_train_ops import _cands
from chip_smoke import recording_grads
from torch_parallel_worker import save_spec, start_ranks, wait_ranks
from torch_train_common import (TINY, jax_select_noise, to_jax, to_torch,
                                train_batch)

B, L, K_TRAIN = 2, 64, 8
ROUTES = {"fused": True, "dense": False}
SEL = dict(L=64, S=48, k_train=16, pad=4)


def _overrides(fused):
    return {"loftr": {**TINY, "loss": {"use_pallas": fused}},
            "trainer": TRAINER}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("train")
    # the ranks start at once and wait for their inputs
    handle = start_ranks("train", out, timeout=150)
    batch = train_batch(B=B, seed=BATCH_SEED)
    jb = to_jax(batch)
    # world_size 1 x 2 rows: the learning rate of world_size 2 x 1 row;
    # JAX's dense route (the Pallas kernels in interpret mode would add a
    # compile; the port's fused route is held to its one-process step,
    # which tests/test_torch_train_step.py holds to JAX's fused one)
    jt = JaxTrainer(_cfg(jax_get_config, fused=False),
                    batch_size_per_device=2)
    # jitted: the same values as the eager init, in a third of the time
    s0 = jax.jit(jt.init_state)(jax.random.PRNGKey(0),
                                jax.tree.map(lambda x: x[:1], jb))
    noise = jax_select_noise(jax.random.split(s0.rng)[1], B, L, K_TRAIN,
                             "per_pair")
    init = state_dict_from_jax(_variables(s0))

    j_ids, mconf, valid, gt_j, gt_valid = _cands(
        B, SEL["L"], SEL["S"], 3, (30, 3), (20, 9))
    key = jax.random.PRNGKey(5)
    sel_want = JM.select_train_matches(
        JM.CandidateMatches(jnp.asarray(j_ids), jnp.asarray(mconf),
                            jnp.asarray(valid)),
        jnp.asarray(gt_j), jnp.asarray(gt_valid), key, SEL["k_train"],
        SEL["pad"], sampling="global_replacement")
    t = torch.from_numpy
    save_spec({
        "batch": {k: t(np.ascontiguousarray(v)) for k, v in batch.items()},
        "init": init, "noise": noise,
        "routes": {r: _overrides(f) for r, f in ROUTES.items()},
        "select": {"cand": {"j_ids": t(j_ids), "mconf": t(mconf),
                            "valid": t(valid)},
                   "gt_j": t(gt_j), "gt_valid": t(gt_valid),
                   "k_train": SEL["k_train"], "pad": SEL["pad"],
                   "noise": jax_select_noise(key, B, SEL["L"],
                                             SEL["k_train"],
                                             "global_replacement")}},
        str(out / "train_spec.pt"))

    s1, sc1 = jax.jit(jt._train_step)(s0, jb)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {}
        for route, fused in ROUTES.items():
            tr = Trainer(get_config("indoor_ds", _overrides(fused)),
                         batch_size_per_device=2, device="cpu")
            st = tr.init_state(seed=0, state_dict=init)
            grads = recording_grads(tr, st)
            st, sc = tr.train_step(st, to_torch(batch), noise=noise)
            one[route] = {"scalars": {k: float(v) for k, v in sc.items()},
                          "after": st.module.state_dict(), "grads": grads}
    finally:
        torch.set_num_threads(n)
    recs = wait_ranks(handle)
    return dict(recs=recs, init=init, one=one,
                jax_after=_variables(s1),
                jax_scalars=jax.tree.map(float, dict(sc1)),
                sel_want=jax.tree.map(np.asarray, sel_want))


class _State:
    """What ``_assert_state`` reads of a TrainState."""

    class _Module:
        def __init__(self, sd, names):
            self._sd, self._names = sd, names

        def state_dict(self):
            return self._sd

        def named_parameters(self):
            return [(n, self._sd[n]) for n in self._names]

    def __init__(self, sd, names):
        self.module = self._Module(sd, names)


def _param_names():
    tr = Trainer(get_config("indoor_ds", _overrides(True)), device="cpu")
    return [n for n, _ in tr.init_state(seed=0).module.named_parameters()]


def test_replicate_gives_every_rank_rank0_weights(run):
    """Rank 1 initialised from seed 0's random weights; replicate gave it
    rank 0's JAX init before the first step."""
    for route in ROUTES:
        for rec in run["recs"]:
            for k, v in run["init"].items():
                assert torch.equal(rec[route]["start"][k], v), (route, k)
        assert run["recs"][0][route]["packing"] == "interleave"


def test_ranks_hold_equal_state_after_the_step(run):
    a, b = run["recs"]
    for route in ROUTES:
        assert a[route]["scalars"] == b[route]["scalars"]
        for k, v in a[route]["after"].items():
            assert torch.equal(v, b[route]["after"][k]), (route, k)


def test_two_ranks_match_jax_single_device_step(run):
    """Loss, loss_c, loss_f, grad_norm and lr, every parameter and the
    BatchNorm running statistics after the step: the global batch's."""
    rec = run["recs"][0]["dense"]
    _assert_scalars(rec["scalars"], run["jax_scalars"])
    _assert_state(_State(rec["after"], _param_names()), run["jax_after"],
                  run["init"], rec["scalars"]["lr"],
                  grads=run["one"]["dense"]["grads"])
    stat = "backbone.bn1.running_var"
    assert not torch.equal(rec["after"][stat], run["init"][stat])


@pytest.mark.parametrize("route", list(ROUTES))
def test_two_ranks_match_one_process_step(run, route):
    got, want = run["recs"][0][route], run["one"][route]
    for k, v in want["scalars"].items():
        assert got["scalars"][k] == pytest.approx(v, rel=1e-5), k
    lr = want["scalars"]["lr"]
    for k, w in want["grads"].items():
        g = got["grads"][k].numpy()
        w = w.numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
        sure = np.abs(w) > 1e-3 * np.abs(w).max()
        a, b = got["after"][k].numpy(), want["after"][k].numpy()
        np.testing.assert_allclose(a[sure], b[sure], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
        np.testing.assert_allclose(a, b, rtol=0, atol=2.2 * lr, err_msg=k)
    for k, v in want["after"].items():       # the running statistics
        if k not in want["grads"] and v.is_floating_point():
            np.testing.assert_allclose(got["after"][k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_global_replacement_selection_matches_jax(run):
    """Quotas share the slots out over the global batch's candidates: the
    ranks' rows, stacked, equal JAX's selection on the global batch."""
    want = run["sel_want"]
    for name in ("i_ids", "j_ids", "mconf", "mask", "gt_mask"):
        got = np.concatenate([rec["select"][name].numpy()
                              for rec in run["recs"]])
        np.testing.assert_array_equal(got, np.asarray(getattr(want, name)),
                                      name)
