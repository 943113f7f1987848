"""PyTorch port: the training slice as a whole against the JAX package.

The JAX ``Trainer`` (fused focal loss through the Pallas kernels in
interpret mode, ``loss.force_pallas_cpu``) and the port's ``Trainer`` on the
CPU (the kernel modules' plain versions) start from the same seeded init,
take the same numpy batch and the same selection noise, and are compared
after one and after two steps at the bars of
tests/test_pallas_loss.py:141-150.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loftr_tpu import get_config as jax_get_config
from loftr_tpu.losses import loftr_loss as jax_loftr_loss
from loftr_tpu.supervision import coarse_supervision as jax_coarse_supervision
from loftr_tpu.supervision import fine_supervision as jax_fine_supervision
from loftr_tpu.train.trainer import Trainer as JaxTrainer
from loftr_tpu_torch import get_config
from loftr_tpu_torch.train.checkpoint import (CheckpointManager, load_params,
                                              save_params)
from loftr_tpu_torch.train.trainer import Trainer
from loftr_tpu_torch.utils.weights import state_dict_from_jax

from torch_train_common import (TINY, jax_select_noise, to_jax, to_torch,
                                train_batch)

# a rate of 1e-4 at the first two updates (linear warm-up from a tenth of
# the true rate): one Adam update moves an element by five times the
# parameter check's atol
TRAINER = {"scheduler_interval": "step", "warmup_step": 10,
           "warmup_ratio": 0.1, "canonical_lr": 6.4e-2}
B, L, K_TRAIN = 2, 64, 8
# The batch is one on which no ReLU input of the backbone lies within the
# two frameworks' float32 difference of zero (training BatchNorm outputs
# differ by up to 1e-4 between them, from the order of their sums).  On
# half of the seeds 0-13 one such element falls on the other side in the
# port; in this tiny net (256 coarse pixels a channel) that one mask bit
# moves the gradients upstream of it by up to 2.4e-2 of a tensor's largest
# entry.  Seeds 1, 4, 9, 11 and 13 have none in either step, and every bar
# below then holds as stated (tools/train_step_seed_scan.py lists them).
BATCH_SEED = 11


def _cfg(get, fused=True, preset="indoor_ds", **loftr):
    loss = {"use_pallas": fused}
    if get is jax_get_config:
        loss["force_pallas_cpu"] = fused
    return get(preset).replaced({
        "loftr": {**TINY, "loss": loss, **loftr}, "trainer": TRAINER})


def _variables(state):
    return jax.tree.map(np.asarray, {"params": state.params,
                                     "batch_stats": state.batch_stats})


def build_ref(seed, preset="indoor_ds"):
    """The JAX side: states and scalars after steps 1 and 2, the selection
    noise of both steps, step 1's gradients and selected matches."""
    batch = train_batch(B=B, seed=seed)
    jb = to_jax(batch)
    jt = JaxTrainer(_cfg(jax_get_config, preset=preset))
    s0 = jt.init_state(jax.random.PRNGKey(0),
                       jax.tree.map(lambda x: x[:1], jb))
    step = jax.jit(jt._train_step)
    s1, sc1 = step(s0, jb)
    s2, sc2 = step(s1, jb)
    sel = [jax.random.split(s.rng)[1] for s in (s0, s1)]
    spv = jax_coarse_supervision(jb, 8)

    @jax.jit
    def matches(state, rng):
        out, _ = jt.model.apply(
            {"params": state.params, "batch_stats": state.batch_stats}, jb,
            train=True, rng=rng, gt_j=spv.gt_j, gt_valid=spv.gt_valid,
            mutable=["batch_stats"])
        return out.coarse

    @jax.jit
    def grads(state, rng):
        def loss_fn(params):      # as Trainer._train_step forms it
            out, _ = jt.model.apply(
                {"params": params, "batch_stats": state.batch_stats}, jb,
                train=True, rng=rng, gt_j=spv.gt_j, gt_valid=spv.gt_valid,
                mutable=["batch_stats"])
            gt = jax_fine_supervision(spv, out.coarse, jb, 2, 5)
            return jax_loftr_loss(out, spv, gt, jb, jt.config.loftr.loss,
                                  jt.config.loftr.match_coarse)[0]
        return jax.grad(loss_fn)(state.params)
    return dict(batch=batch,
                grads=state_dict_from_jax({"params": jax.tree.map(
                    np.asarray, grads(s0, sel[0]))}),
                grads2=state_dict_from_jax({"params": jax.tree.map(
                    np.asarray, grads(s1, sel[1]))}), init=_variables(s0),
                after=[_variables(s1), _variables(s2)],
                scalars=[jax.tree.map(float, dict(sc1)),
                         jax.tree.map(float, dict(sc2))],
                noise=[jax_select_noise(k, B, L, K_TRAIN, "per_pair")
                       for k in sel],
                coarse=jax.tree.map(np.asarray, matches(s0, sel[0])))


@pytest.fixture(scope="module")
def ref():
    return build_ref(BATCH_SEED)


def _port_state(ref, fused=True, preset="indoor_ds", **loftr):
    trainer = Trainer(_cfg(get_config, fused, preset, **loftr), device="cpu")
    return trainer, trainer.init_state(
        seed=0, state_dict=state_dict_from_jax(ref["init"]))


def _assert_state(state, variables, before, lr, grads=None):
    """Every parameter and running statistic at rtol 2e-3 / atol 2e-5, and
    every parameter's movement since ``before`` within half a learning
    rate of the JAX one: an Adam update moves an element by about ``lr``,
    so an update that is missing or has the wrong sign is a whole or two
    learning rates off, wherever rtol * |w| would hide it.

    With ``grads`` (the JAX gradients of a first step): Adam's first update
    is ``lr * g / (|g| + eps)``, about ``lr * sign(g)``, so an element whose
    gradient lies below the gradient comparison's own atol (1e-3 of the
    tensor's largest entry) has no determined sign; those elements are held
    to 2.2 learning rates, all others as above."""
    want = state_dict_from_jax(variables)
    got = state.module.state_dict()
    assert set(got) == set(want)
    params = {n for n, _ in state.module.named_parameters()}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g, w = got[k].numpy(), w.numpy()
        sure = np.ones(w.shape, bool)
        if grads is not None and k in params:
            gr = np.abs(grads[k].numpy())
            sure = gr > 1e-3 * gr.max()
            assert sure.mean() > 0.5, k
            np.testing.assert_allclose(g, w, rtol=0, atol=2.2 * lr, err_msg=k)
        np.testing.assert_allclose(g[sure], w[sure], rtol=2e-3, atol=2e-5,
                                   err_msg=k)
        if k in params:
            b = before[k].numpy()
            assert np.abs(w - b).max() > 0.5 * lr, k      # JAX did move it
            np.testing.assert_allclose((g - b)[sure], (w - b)[sure], rtol=0,
                                       atol=0.5 * lr, err_msg=k)


def _assert_scalars(got, want):
    for k in ("loss", "loss_c", "loss_f"):
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["grad_norm"]), want["grad_norm"],
                               rtol=1e-3)
    np.testing.assert_allclose(float(got["lr"]), want["lr"], rtol=1e-6)


def test_selected_matches_are_exact(ref):
    trainer, state = _port_state(ref)
    _, _, out = trainer.forward_loss(state, to_torch(ref["batch"]),
                                     ref["noise"][0])
    want = ref["coarse"]
    for name in ("i_ids", "j_ids", "mask", "gt_mask"):
        np.testing.assert_array_equal(getattr(out.coarse, name).numpy(),
                                      getattr(want, name), name)
    assert out.conf_matrix is None and out.feat_c0 is not None
    assert out.feat_c0.requires_grad and not out.mkpts1_f.requires_grad


def test_gradients_match_jax(ref):
    """Every parameter's gradient of step 1 against jax.grad of the same
    loss: rtol 1e-3 (the bar of the focal kernels' gradients), atol 1e-3 of
    the tensor's largest entry, backbone included."""
    trainer, state = _port_state(ref)
    loss, _, _ = trainer.forward_loss(state, to_torch(ref["batch"]),
                                      ref["noise"][0])
    names = [n for n, _ in state.module.named_parameters()]
    got = torch.autograd.grad(loss, list(state.module.parameters()))
    assert set(names) == set(ref["grads"])
    for n, g in zip(names, got):
        w = ref["grads"][n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(w).max()),
                                   err_msg=n)


def test_two_train_steps_match_jax(ref):
    trainer, state = _port_state(ref)
    batch = to_torch(ref["batch"])
    before = {k: v.clone() for k, v in state.module.state_dict().items()}
    start = before
    for i in (0, 1):
        state, sc = trainer.train_step(state, batch, ref["noise"][i])
        _assert_scalars(sc, ref["scalars"][i])
        _assert_state(state, ref["after"][i], start, sc["lr"])
        start = state_dict_from_jax(ref["after"][i])
    assert state.step == 2
    after = state.module.state_dict()
    k = "loftr_coarse.layers.0.q_proj.weight"
    assert not torch.equal(before[k], after[k])           # it did update
    assert not torch.equal(before["backbone.bn1.running_var"],
                           after["backbone.bn1.running_var"])


@pytest.fixture(scope="module")
def ref_ot():
    return build_ref(BATCH_SEED, preset="indoor_ot")


def test_ot_train_step_matches_jax(ref_ot):
    """An ``indoor_ot`` step (dense supervision, focal loss on the
    materialised Sinkhorn confidence): the selected matches exactly, every
    gradient, ``coarse_matching.bin_score`` included, at the bars of
    test_gradients_match_jax, then the step's scalars and state.  AdamW
    decays the scalar like every other parameter, as ``optax.adamw``
    does."""
    ref = ref_ot
    batch = to_torch(ref["batch"])
    trainer, state = _port_state(ref, preset="indoor_ot")
    loss, _, out = trainer.forward_loss(state, batch, ref["noise"][0])
    assert out.conf_matrix is not None and out.feat_c0 is None
    assert out.conf_matrix_with_bin is None           # dense supervision
    for name in ("i_ids", "j_ids", "mask", "gt_mask"):
        np.testing.assert_array_equal(getattr(out.coarse, name).numpy(),
                                      getattr(ref["coarse"], name), name)
    names = [n for n, _ in state.module.named_parameters()]
    assert "coarse_matching.bin_score" in names
    assert set(names) == set(ref["grads"])
    got = torch.autograd.grad(loss, list(state.module.parameters()))
    for n, g in zip(names, got):
        w = ref["grads"][n].numpy()
        assert g.shape == w.shape, n
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(w).max()),
                                   err_msg=n)
    g_bin = dict(zip(names, got))["coarse_matching.bin_score"]
    assert torch.isfinite(g_bin) and float(g_bin) != 0.0

    trainer, state = _port_state(ref, preset="indoor_ot")
    before = {k: v.clone() for k, v in state.module.state_dict().items()}
    state, sc = trainer.train_step(state, batch, ref["noise"][0])
    _assert_scalars(sc, ref["scalars"][0])
    _assert_state(state, ref["after"][0], before, sc["lr"], ref["grads"])
    k = "coarse_matching.bin_score"
    assert not torch.equal(before[k], state.module.state_dict()[k])
    groups = state.optimizer.param_groups
    assert len(groups) == 1 and groups[0]["weight_decay"] == 0.1
    assert any(p is state.module.coarse_matching.bin_score
               for p in groups[0]["params"])


def test_fused_and_dense_routes_agree(ref):
    """loss.use_pallas on (features to the focal function) and off (the
    conf matrix to coarse_loss): the same step."""
    batch = to_torch(ref["batch"])
    res = []
    for fused in (True, False):
        trainer, state = _port_state(ref, fused=fused)
        _, _, out = trainer.forward_loss(state, batch, ref["noise"][0])
        assert (out.conf_matrix is None) == fused
        trainer, state = _port_state(ref, fused=fused)
        state, sc = trainer.train_step(state, batch, ref["noise"][0])
        res.append((sc, state.module.state_dict()))
    (sa, pa), (sb, pb) = res
    for k in ("loss", "loss_c", "loss_f"):
        np.testing.assert_allclose(float(sa[k]), float(sb[k]), rtol=1e-4)
    np.testing.assert_allclose(float(sa["grad_norm"]), float(sb["grad_norm"]),
                               rtol=1e-3)
    for k in pa:
        np.testing.assert_allclose(pa[k].float().numpy(),
                                   pb[k].float().numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=k)
    _assert_scalars(sb, ref["scalars"][0])


def test_checkpoint_restore_gives_the_same_second_step(ref, tmp_path):
    batch = to_torch(ref["batch"])
    trainer, state = _port_state(ref)
    state, _ = trainer.train_step(state, batch)     # generator-driven
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state.step, state, {"auc@10": 0.5})
    assert mgr.latest_step() == 1
    state, sc_a = trainer.train_step(state, batch)
    want = {k: v.clone() for k, v in state.module.state_dict().items()}

    trainer2, fresh = _port_state(ref)
    fresh = CheckpointManager(str(tmp_path / "ck")).restore(fresh)
    assert fresh.step == 1
    fresh, sc_b = trainer2.train_step(fresh, batch)
    assert float(sc_a["loss"]) == float(sc_b["loss"])
    for k, v in fresh.module.state_dict().items():
        assert torch.equal(v, want[k]), k

    save_params(str(tmp_path / "params.pt"), state.module)
    sd = load_params(str(tmp_path / "params.pt"))
    assert torch.equal(sd["backbone.conv1.weight"],
                       want["backbone.conv1.weight"])


def test_checkpoint_manager_keeps_the_best_k(tmp_path):
    trainer = Trainer(_cfg(get_config), device="cpu")
    state = trainer.init_state(seed=1)
    mgr = CheckpointManager(str(tmp_path), save_top_k=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    for step, auc in [(1, 0.3), (2, 0.6), (3, 0.1), (4, 0.5)]:
        state.step = step
        mgr.save(step, state, {"auc@10": auc})
    kept = sorted(p.name for p in tmp_path.glob("step_*.pt"))
    assert kept == ["step_00000002.pt", "step_00000004.pt"]
    again = CheckpointManager(str(tmp_path), save_top_k=2)
    assert again.latest_step() == 4
    assert again.restore(state, step=2).step == 2


def test_accumulation_and_bf16_and_hybrid_fine_run(ref):
    """accum_steps=2 updates every second step; bfloat16 keeps float32
    parameters; fine.use_pallas_train goes through the hybrid fine stage."""
    batch = to_torch(ref["batch"])
    cfg = _cfg(get_config).replaced({"trainer": {"accum_steps": 2}})
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(seed=0,
                               state_dict=state_dict_from_jax(ref["init"]))
    k = "loftr_fine.layers.0.q_proj.weight"
    w0 = state.module.state_dict()[k].clone()
    state, _ = trainer.train_step(state, batch)
    assert torch.equal(state.module.state_dict()[k], w0)
    assert state.accum is not None
    state, _ = trainer.train_step(state, batch)
    assert not torch.equal(state.module.state_dict()[k], w0)
    assert state.accum is None

    for loftr in ({"dtype": "bfloat16"},
                  {"fine": {**TINY["fine"], "use_pallas_train": True}}):
        trainer = Trainer(_cfg(get_config, True, **loftr), device="cpu")
        state = trainer.init_state(seed=3)
        state, sc = trainer.train_step(state, batch)
        assert np.isfinite(float(sc["loss"])) and float(sc["grad_norm"]) > 0
        assert all(p.dtype == torch.float32
                   for p in state.module.parameters())


def test_eval_and_val_steps_and_mode_check(ref):
    trainer, state = _port_state(ref)
    batch = to_torch(ref["batch"])
    out = trainer.eval_step(state, batch)
    assert out.expec_f.shape[:2] == out.coarse.i_ids.shape
    assert not out.expec_f.requires_grad
    out, sc = trainer.val_step(state, batch)
    assert out.conf_matrix is not None
    assert np.isfinite(float(sc["loss"]))
    with pytest.raises(ValueError, match="mode"):
        state.module.train()(batch)
    with pytest.raises(ValueError, match="mode"):
        state.module.eval()(batch, train=True)
    with pytest.raises(ValueError, match="supervision"):
        state.module.train()(batch, train=True)


def _both(ref):
    """For the state after a second step: each element's smaller gradient
    of the two steps, each relative to its tensor's largest.  The state
    carries both updates, and each has a determined sign only where its
    step's gradient lies above the comparison's atol (the first step's
    undetermined elements moved by a whole learning rate either way)."""
    out = {}
    for k, g1 in ref["grads"].items():
        a, b = g1.abs(), ref["grads2"][k].abs()
        out[k] = torch.minimum(a / a.max(), b / b.max())
    return out


@pytest.fixture(scope="module")
def ref_sparse():
    return build_ref(BATCH_SEED, preset="default")


def test_sparse_default_train_step_matches_jax(ref_sparse):
    """The ``default`` preset, the accuracy benchmark's
    (``tools/synthetic_benchmark.py``): sparse supervision, the dual-softmax
    confidence matrix formed with autograd and the loss on its GT cells
    only. The selected matches exactly, every gradient at the bars of
    test_gradients_match_jax, then two steps' scalars and state."""
    ref = ref_sparse
    batch = to_torch(ref["batch"])
    trainer, state = _port_state(ref, preset="default")
    assert trainer.config.loftr.match_coarse.sparse_spvs
    loss, _, out = trainer.forward_loss(state, batch, ref["noise"][0])
    assert out.conf_matrix is not None and out.feat_c0 is None
    for name in ("i_ids", "j_ids", "mask", "gt_mask"):
        np.testing.assert_array_equal(getattr(out.coarse, name).numpy(),
                                      getattr(ref["coarse"], name), name)
    names = [n for n, _ in state.module.named_parameters()]
    assert set(names) == set(ref["grads"])
    got = torch.autograd.grad(loss, list(state.module.parameters()))
    for n, g in zip(names, got):
        w = ref["grads"][n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(w).max()),
                                   err_msg=n)
    trainer, state = _port_state(ref, preset="default")
    start = {k: v.clone() for k, v in state.module.state_dict().items()}
    for i in (0, 1):
        state, sc = trainer.train_step(state, batch, ref["noise"][i])
        _assert_scalars(sc, ref["scalars"][i])
        _assert_state(state, ref["after"][i], start, sc["lr"],
                      ref["grads"] if i == 0 else _both(ref))
        start = state_dict_from_jax(ref["after"][i])
