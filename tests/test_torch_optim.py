"""PyTorch port: LR schedule and optimizer updates against the JAX package
(loftr_tpu.train.optim on optax)."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import loftr_tpu.config as jcfg
import loftr_tpu_torch.config as tcfg
from loftr_tpu.train import optim as JO
from loftr_tpu_torch.config import get_config
from loftr_tpu_torch.train import optim as TO
from loftr_tpu_torch.train.trainer import Trainer, TrainState

STEPS = [0, 1, 2, 5, 9, 10, 11, 19, 20, 21, 29, 30, 59, 60, 61, 90, 119, 120,
         121, 200]


@pytest.mark.parametrize("scheduler,interval,warmup", [
    ("MultiStepLR", "epoch", "linear"), ("MultiStepLR", "step", "constant"),
    ("CosineAnnealing", "epoch", "linear"),
    ("CosineAnnealing", "step", "constant"),
    ("ExponentialLR", "step", "linear"), ("ExponentialLR", "epoch", "constant"),
])
def test_lr_schedule_matches_jax(scheduler, interval, warmup):
    kw = dict(scheduler=scheduler, scheduler_interval=interval,
              warmup_type=warmup, warmup_ratio=0.1, steps_per_epoch=10,
              mslr_milestones=(3, 6, 9, 12), cosa_tmax=30,
              elr_gamma=0.97)
    jf = JO.lr_schedule(jcfg.TrainerConfig(**kw), 6e-3, 20)
    tf = TO.lr_schedule(tcfg.TrainerConfig(**kw), 6e-3, 20)
    want = np.array([float(jf(s)) for s in STEPS])
    got = np.array([tf(s) for s in STEPS])
    # the port computes in Python floats, the JAX function in float32:
    # gamma**t carries gamma's float32 rounding t times (3e-8 * 120), and
    # the cosine cancels to 1e-7 of the base rate near its zero
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    assert got[0] == pytest.approx(6e-4) and len(set(got)) > 1


def test_lr_schedule_rejects_bad_settings():
    with pytest.raises(ValueError):
        TO.lr_schedule(tcfg.TrainerConfig(scheduler="nope"), 1e-3, 0)
    with pytest.raises(ValueError):
        TO.lr_schedule(tcfg.TrainerConfig(), 1e-3, 0)(5)  # no steps_per_epoch
    with pytest.raises(ValueError):
        TO.build_optimizer([torch.nn.Parameter(torch.zeros(1))],
                           tcfg.TrainerConfig(optimizer="sgd"), 1e-3)


def test_scaled_lr_matches_jax():
    for accum in (1, 2):
        o = {"trainer": {"accum_steps": accum}}
        assert tcfg.get_config("indoor_ds", o).scaled_lr(2, 4) == \
            jcfg.get_config("indoor_ds", o).scaled_lr(2, 4)


def _params_and_grads(seed=0, n=10):
    rng = np.random.RandomState(seed)
    shapes = [(4, 3), (7,), (2, 3, 3)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    # norms straddle the clip of 0.5
    grads = [[(rng.randn(*s) * sc).astype(np.float32) for s in shapes]
             for sc in np.linspace(0.02, 0.6, n)]
    return params, grads


@pytest.mark.parametrize("optimizer,accum", [("adamw", 1), ("adamw", 2),
                                             ("adam", 1)])
def test_updates_match_optax(optimizer, accum):
    """Five real updates with clipping (ten micro-steps with accum=2) on
    the same numpy gradients, through the Trainer's own update routine."""
    kw = dict(optimizer=optimizer, adam_decay=0.05, scheduler_interval="step",
              warmup_step=3, warmup_ratio=0.1, mslr_milestones=(4,),
              accum_steps=accum)
    params, grads = _params_and_grads(n=5 * accum)
    true_lr = 2e-2
    tx = JO.build_optimizer(jcfg.TrainerConfig(**kw), true_lr, 3)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)

    cfg = get_config("indoor_ds", {"trainer": kw})
    trainer = Trainer(cfg, device="cpu")
    trainer._lr_sched = TO.lr_schedule(cfg.trainer, true_lr, 3)
    module = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    state = TrainState(
        step=0, module=module, generator=torch.Generator(),
        optimizer=TO.build_optimizer(module.parameters(), cfg.trainer,
                                     true_lr))
    norms = []
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state,
                                       jp)
        jp = optax.apply_updates(jp, updates)
        norms.append(float(TO.global_norm([torch.from_numpy(x) for x in g])))
        trainer.apply_gradients(state, [torch.from_numpy(x.copy())
                                        for x in g])
        for a, b in zip(module, jp):
            # float32 on both sides; the two libraries order the update's
            # operations differently: two ulps at |p| ~ 2 (2.4e-7 each)
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=5e-7)
    assert state.step == 5 * accum and state.accum is None
    assert min(norms) < 0.5 < max(norms)
    assert not np.allclose(module[0].detach().numpy(), params[0])


def test_clip_by_global_norm_is_optax_form():
    g = [torch.full((4,), 3.0), torch.full((3,), -4.0)]
    want = float(optax.global_norm([jnp.asarray(x.numpy()) for x in g]))
    norm = TO.clip_by_global_norm(g, 0.5)
    assert float(norm) == pytest.approx(want, rel=1e-6)
    assert float(TO.global_norm(g)) == pytest.approx(0.5, rel=1e-6)
    small = [torch.full((2,), 0.1)]
    TO.clip_by_global_norm(small, 0.5)
    assert torch.equal(small[0], torch.full((2,), 0.1))   # factor exactly 1


def test_trainer_one_rank_group_gives_the_plain_step(tmp_path):
    """Trainer(group=...) runs the data-parallel step (the collectives of
    BatchNorm, the losses, the selection and the gradient sum) over a gloo
    group of this process alone: the plain step's scalars and parameters
    bit for bit.  world_size > 1 without a process group raises."""
    from torch_parallel_worker import one_rank_group
    from torch_train_common import TINY, to_torch, train_batch
    cfg = get_config("indoor_ds", {"loftr": TINY, "trainer": {
        "scheduler_interval": "step"}})
    batch = to_torch(train_batch(B=2, seed=11))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = Trainer(cfg, batch_size_per_device=2, device="cpu")
        st, sc = plain.train_step(plain.init_state(seed=0), batch)
        with one_rank_group(tmp_path / "store") as group:
            dp = Trainer(cfg, batch_size_per_device=2, device="cpu",
                         group=group)
            st1, sc1 = dp.train_step(dp.init_state(seed=0), batch)
    finally:
        torch.set_num_threads(n)
    assert dp.group is group and plain.group is None
    assert {k: float(v) for k, v in sc.items()} == \
        {k: float(v) for k, v in sc1.items()}
    for k, v in st.module.state_dict().items():
        assert torch.equal(v, st1.module.state_dict()[k]), k
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(cfg, world_size=2, device="cpu")
