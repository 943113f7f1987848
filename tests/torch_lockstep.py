"""Lockstep training of the JAX package and the port, step for step, on the
CPU in float32, at the accuracy configuration of the two
``synthetic_benchmark.py`` tools.

Both frameworks start from JAX's init (carried across by
``state_dict_from_jax``), take the same numpy batches in the same order
(drawn once by the JAX tool's sampler rng and loader) and JAX's selection
uniforms every step (``jax_select_noise``).  Every step records the loss
and its terms, the gradient norm before clipping and the learning rate of
both, the relative parameter distance per module group (backbone, coarse,
fine) and the relative distance of the BatchNorm running statistics.

Every ``--anchor-every`` steps the port is also restarted from JAX's full
state before the step (parameters, running statistics, AdamW moments and
count) and takes that one step beside JAX: its distances to JAX's state
after the step (``anchor``) are the port's error of one step, free of the
growth that two free-running float32 trajectories show in a chaotic
system.

Usage (CPU; a few seconds a step):
  python tests/torch_lockstep.py --steps 2000 --seed 2 \\
      --work-dir build/lockstep --out perf/torch_lockstep_seed2.json

``--components N ...`` takes the step N from JAX's state apart, one
component at a time (supervision, selection, fine targets and predictions,
each loss term, gradients, clip, the optimizer's update, running
statistics).  ``--hybrid`` replaces the port by a run that takes the port's gradients
and running statistics and JAX's optimizer, ``--opt-hybrid`` by one that
takes JAX's and the port's optimizer.  ``--jax-twin`` replaces the
port by a second JAX run whose initial
parameters are one float32 ulp up (the control: how fast two float32 runs
of one program part).  ``--teacher`` restarts the port from JAX's state before every step and
keeps no free-running port: every record is then an anchor, at the cost of
one port step a step (the CPU test runs so).

The run snapshots both states every ``--chunk`` steps into the work
directory; ``--resume`` continues from the last snapshot.  ``--evaluate``
reads the last snapshot instead of training and evaluates both states on
the seed's 3 held-out scenes (63 pairs, float32, OpenCV at 1.5 px): the
port's state through the port's eval CLI, JAX's through JAX's ``test.py``
and, as the check that the two evaluators agree, through the port's::

  python tests/torch_lockstep.py --work-dir build/lockstep --evaluate  The record names
the first step at which a loss term or a group's distance grows by more
than ``--jump`` times in one step (above a floor of float32 noise).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import os.path as osp
import pickle
import sys
import time

import numpy as np

HERE = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(HERE)
for p in (REPO, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

GROUPS = ("backbone", "coarse", "fine")
SCALARS = ("loss", "loss_c", "loss_f", "grad_norm", "lr")
# floors under which a step-to-step growth is not called a jump: float32
# noise of a distance, of a loss term
DIST_FLOOR = 1e-6
LOSS_FLOOR = 1e-5


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_synthetic_benchmark", osp.join(REPO, "tools",
                                            "synthetic_benchmark.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def group_of(key: str) -> str:
    if key.startswith("backbone."):
        return "backbone"
    if key.startswith(("loftr_fine.", "fine_preprocess.")):
        return "fine"
    return "coarse"


def configs(steps, batch, lr, seed, sampling="per_pair", fine_type=None):
    """The JAX tool's and the port tool's training configs; ``fine_type``
    replaces ``loss.fine_type`` in both."""
    from loftr_tpu import get_config as jax_get_config
    from loftr_tpu_torch import get_config
    from loftr_tpu_torch.tools.synthetic_benchmark import SMALL_MODEL
    over = {"loftr": {"match_coarse": {"train_sampling": sampling}},
            "trainer": {"canonical_bs": batch, "canonical_lr": lr,
                        "scheduler_interval": "step", "warmup_step": 50,
                        "scheduler": "CosineAnnealing", "cosa_tmax": steps,
                        "seed": seed}}
    if fine_type:
        over["loftr"]["loss"] = {"fine_type": fine_type}
    return (jax_get_config("default", _jax_tool().SMALL_MODEL).replaced(over),
            get_config("default", SMALL_MODEL).replaced(over))


class Batches:
    """The JAX tool's batch order: one ``RandomState(seed)`` permutation an
    epoch, the JAX loader, ``drop_last``; ``start`` skips whole steps."""

    def __init__(self, work_dir, train_npzs, img_size, img_resize, batch,
                 seed):
        from loftr_tpu.data.megadepth import MegaDepthDataset
        from loftr_tpu.data.sampler import ConcatDataset
        self.concat = ConcatDataset([MegaDepthDataset(
            work_dir, p, mode="train", min_overlap_score=0.0,
            img_resize=img_resize, df=8, img_padding=True,
            depth_padding=True, depth_max_size=img_size)
            for p in train_npzs])
        self.batch, self.seed = batch, seed
        self.per_epoch = len(self.concat) // batch

    def iterate(self, start=0):
        from loftr_tpu.data import DataLoader
        rng = np.random.RandomState(self.seed)
        step = 0
        while True:
            order = rng.permutation(len(self.concat)).tolist()
            if step + self.per_epoch <= start:
                step += self.per_epoch
                continue
            skip = max(0, start - step)
            for inp, _ in DataLoader(self.concat, self.batch,
                                     sampler=order[skip * self.batch:],
                                     num_workers=2, drop_last=True):
                yield {k: np.asarray(v) for k, v in inp._asdict().items()
                       if v is not None} if hasattr(inp, "_asdict") else \
                    {k: np.asarray(getattr(inp, k)) for k in
                     inp.__dataclass_fields__ if getattr(inp, k) is not None}
            step += self.per_epoch


def _variables(jstate):
    return jax.tree.map(np.asarray, {"params": jstate.params,
                                     "batch_stats": jstate.batch_stats})


def adam_state(opt_state):
    """The ``ScaleByAdamState`` inside the optax chain."""
    stack = [opt_state]
    while stack:
        s = stack.pop()
        if hasattr(s, "mu") and hasattr(s, "nu"):
            return s
        if isinstance(s, (tuple, list)):
            stack.extend(s)
    raise KeyError("no Adam state in the optax state")


def port_from_jax(trainer, jstate, seed):
    """A port TrainState equal to JAX's: parameters, running statistics,
    AdamW moments and count, the step."""
    from loftr_tpu_torch.utils.weights import state_dict_from_jax
    state = trainer.init_state(seed, state_dict=state_dict_from_jax(
        _variables(jstate)))
    adam = adam_state(jstate.opt_state)
    count = int(np.asarray(adam.count))
    if count:
        mu = state_dict_from_jax({"params": jax.tree.map(np.asarray,
                                                         adam.mu)})
        nu = state_dict_from_jax({"params": jax.tree.map(np.asarray,
                                                         adam.nu)})
        for name, p in state.module.named_parameters():
            state.optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}
    state.step = int(np.asarray(jstate.step))
    return state


def distances(module, jstate, got=None, want=None):
    """Relative L2 distance of the port's parameters to JAX's, per group,
    and of the running statistics (mean and var apart).  ``got``: a state
    dict to use instead of the module's (a twin's); ``want``: one to use
    instead of JAX's."""
    from loftr_tpu_torch.utils.weights import state_dict_from_jax
    if want is None:
        want = state_dict_from_jax(_variables(jstate))
    got = module.state_dict() if got is None else got
    num = {g: 0.0 for g in GROUPS + ("bn_mean", "bn_var")}
    den = dict(num)
    params = {n for n, _ in module.named_parameters()}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k in params:
            g = group_of(k)
        elif k.endswith("running_mean"):
            g = "bn_mean"
        elif k.endswith("running_var"):
            g = "bn_var"
        else:
            continue
        d = got[k].detach().double() - w.double()
        num[g] += float((d ** 2).sum())
        den[g] += float((w.double() ** 2).sum())
    return {g: (num[g] / den[g]) ** 0.5 if den[g] else 0.0 for g in num}


def _scalars(sc):
    return {k: float(np.asarray(sc[k])) for k in SCALARS if k in sc}


def first_jump(records, factor):
    """The first step where a group distance or a loss term's relative
    difference grows by more than ``factor`` in one step, above its floor."""
    prev = None
    for r in records:
        cur = dict(r["dist"])
        for k in ("loss", "loss_c", "loss_f"):
            cur["rel_" + k] = r["rel"][k]
        if prev is not None:
            for k, v in cur.items():
                floor = LOSS_FLOOR if k.startswith("rel_") else DIST_FLOOR
                if v > factor * max(prev[k], floor):
                    return {"step": r["step"], "what": k, "before": prev[k],
                            "after": v}
        prev = cur
    return None


def hybrid_step(jt, pt, hstate, nb, noise, seed):
    """One step of a JAX-form state with the port's forward, loss,
    gradients and running statistics and JAX's optimizer (clip, AdamW,
    schedule): the control that tells the two halves of a step apart."""
    import optax
    from loftr_tpu.utils.weights import convert_torch_state_dict
    from torch_train_common import to_torch
    state = port_from_jax(pt, hstate, seed)
    loss, sc, _ = pt.forward_loss(state, to_torch(nb), noise)
    names = [n for n, _ in state.module.named_parameters()]
    grads = torch.autograd.grad(loss, list(state.module.parameters()),
                                allow_unused=True)
    sd = {n: (torch.zeros_like(p) if g is None else g).detach().numpy()
          for n, g, p in zip(names, grads, state.module.parameters())}
    jgrads = convert_torch_state_dict(sd)["params"]
    stats = convert_torch_state_dict({
        k: v.numpy() for k, v in state.module.state_dict().items()
        if k.endswith(("running_mean", "running_var"))})["batch_stats"]
    jgrads = jax.tree.map(jax.numpy.asarray, jgrads)
    updates, opt = jt.tx.update(jgrads, hstate.opt_state, hstate.params)
    new = hstate.replace(
        step=hstate.step + 1, params=optax.apply_updates(hstate.params,
                                                        updates),
        batch_stats=jax.tree.map(jax.numpy.asarray, stats), opt_state=opt,
        rng=jax.random.split(hstate.rng)[0])
    sc = {k: v.detach() for k, v in sc.items()}
    sc["grad_norm"] = optax.global_norm(jgrads)
    sc["lr"] = jt._lr_sched(hstate.step)
    return new, sc


def jax_grad_fn(jt):
    """Jitted (params, batch_stats, batch, selection key) -> (gradients,
    running statistics after the forward, scalars) of JAX's step."""
    from loftr_tpu.losses import loftr_loss as jloss
    from loftr_tpu.supervision import coarse_supervision as jcs
    from loftr_tpu.supervision import fine_supervision as jfs
    cfg = jt.config
    res_c, res_f = cfg.loftr.backbone.resolution

    def fwd(params, bs, batch, sel):
        spv = jcs(batch, res_c)
        out, mut = jt.model.apply(
            {"params": params, "batch_stats": bs}, batch, train=True,
            rng=sel, gt_j=spv.gt_j, gt_valid=spv.gt_valid,
            mutable=["batch_stats"])
        gt = jfs(spv, out.coarse, batch, res_f, cfg.loftr.fine.window_size)
        loss, sc = jloss(out, spv, gt, batch, cfg.loftr.loss,
                         cfg.loftr.match_coarse)
        return loss, (sc, mut["batch_stats"])

    @jax.jit
    def fn(params, bs, batch, sel):
        (_, (sc, new_bs)), g = jax.value_and_grad(fwd, has_aux=True)(
            params, bs, batch, sel)
        return g, new_bs, sc
    return fn


def opt_hybrid_step(pt, grad_fn, pstate, jb, sel):
    """One step of a port-form state with JAX's forward, loss, gradients
    and running statistics and the port's optimizer (clip, AdamW,
    schedule): the other half of ``hybrid_step``'s control."""
    from loftr_tpu.utils.weights import convert_torch_state_dict
    from loftr_tpu_torch.utils.weights import state_dict_from_jax
    var = convert_torch_state_dict({k: v.numpy() for k, v in
                                    pstate.module.state_dict().items()
                                    if not k.endswith("num_batches_tracked")})
    var = jax.tree.map(jax.numpy.asarray, var)
    g, new_bs, sc = grad_fn(var["params"], var["batch_stats"], jb, sel)
    grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, g)})
    stats = state_dict_from_jax({"batch_stats": jax.tree.map(np.asarray,
                                                             new_bs)})
    names = [n for n, _ in pstate.module.named_parameters()]
    sc = {k: torch.tensor(float(np.asarray(v))) for k, v in sc.items()}
    from loftr_tpu_torch.train.optim import global_norm
    sc["grad_norm"] = global_norm([grads[n] for n in names])
    sc["lr"] = pt.apply_gradients(pstate, [grads[n] for n in names])
    with torch.no_grad():
        sd = pstate.module.state_dict()
        for k, v in stats.items():
            if not k.endswith("num_batches_tracked"):
                sd[k].copy_(v)
    return pstate, sc


def components(jt, pt, jstate, nb, noise, seed):
    """One step from JAX's state taken apart, JAX against the port, one
    component at a time: supervision, selection, the fine targets and
    predictions, each loss term, the gradients per module group, the
    global norm and clip, the optimizer's update per group and the
    running statistics after the step."""
    import jax.numpy as jnp
    import optax
    from loftr_tpu.losses import loftr_loss as jloss
    from loftr_tpu.structs import MatchInput as JaxMatchInput
    from loftr_tpu.supervision import coarse_supervision as jcs
    from loftr_tpu.supervision import fine_supervision as jfs
    from loftr_tpu_torch.supervision import (coarse_supervision,
                                             fine_supervision)
    from loftr_tpu_torch.train.optim import global_norm
    from loftr_tpu_torch.utils.weights import state_dict_from_jax
    from torch_train_common import to_torch

    cfg = jt.config
    res_c, res_f = cfg.loftr.backbone.resolution
    win = cfg.loftr.fine.window_size
    jb = JaxMatchInput(**{k: jnp.asarray(v) for k, v in nb.items()})
    sel = jax.random.split(jstate.rng)[1]

    def fwd(params, bs):
        spv = jcs(jb, res_c)
        out, mut = jt.model.apply(
            {"params": params, "batch_stats": bs}, jb, train=True, rng=sel,
            gt_j=spv.gt_j, gt_valid=spv.gt_valid, mutable=["batch_stats"])
        gt = jfs(spv, out.coarse, jb, res_f, win)
        loss, sc = jloss(out, spv, gt, jb, cfg.loftr.loss,
                         cfg.loftr.match_coarse)
        return loss, (sc, out, spv, gt, mut["batch_stats"])

    (_, (jsc, jout, jspv, jgt, jbs)), jgrads = jax.jit(jax.value_and_grad(
        fwd, has_aux=True))(jstate.params, jstate.batch_stats)
    updates, _ = jt.tx.update(jgrads, jstate.opt_state, jstate.params)
    jnew = state_dict_from_jax(jax.tree.map(np.asarray, {
        "params": optax.apply_updates(jstate.params, updates),
        "batch_stats": jbs}))

    state = port_from_jax(pt, jstate, seed)
    before = {k: v.clone() for k, v in state.module.state_dict().items()}
    tb = to_torch(nb)
    loss, psc, pout = pt.forward_loss(state, tb, noise)
    pspv = coarse_supervision(tb, res_c)
    pgt = fine_supervision(pspv, pout.coarse, tb, res_f, win)
    names = [n for n, _ in state.module.named_parameters()]
    pgrads = dict(zip(names, torch.autograd.grad(
        loss, list(state.module.parameters()), allow_unused=True)))
    jg = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})
    out = {"supervision_equal": bool(
        np.array_equal(np.asarray(jspv.gt_j), pspv.gt_j.numpy())
        and np.array_equal(np.asarray(jspv.gt_valid),
                           pspv.gt_valid.numpy()))}
    for f in ("i_ids", "j_ids", "mask", "gt_mask"):
        out[f + "_equal"] = bool(np.array_equal(
            np.asarray(getattr(jout.coarse, f)),
            getattr(pout.coarse, f).numpy()))
    rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                       1e-30))
    out["mconf_rel"] = rel(pout.coarse.mconf.detach().numpy(),
                           np.asarray(jout.coarse.mconf))
    je, pe = np.asarray(jout.expec_f), pout.expec_f.detach().numpy()
    out["expec_f_xy_max_abs"] = float(np.abs(je[..., :2] - pe[..., :2]).max())
    out["std_min"] = [float(je[..., 2].min()), float(pe[..., 2].min())]
    out["mean_inv_std"] = [float(np.mean(1 / je[..., 2])),
                           float(np.mean(1 / pe[..., 2]))]
    out["expec_f_gt_max_abs"] = float(np.abs(np.asarray(jgt)
                                             - pgt.numpy()).max())
    out["loss_rel"] = {k: abs(float(psc[k]) - float(jsc[k]))
                       / max(abs(float(jsc[k])), 1e-30)
                       for k in ("loss", "loss_c", "loss_f")}
    num = {g: 0.0 for g in GROUPS}
    den = dict(num)
    for n in names:
        g = pgrads[n]
        g = np.zeros_like(jg[n].numpy()) if g is None else g.numpy()
        num[group_of(n)] += float(((g - jg[n].numpy()) ** 2).sum())
        den[group_of(n)] += float((jg[n].numpy() ** 2).sum())
    out["grad_rel"] = {g: (num[g] / den[g]) ** 0.5 if den[g] else 0.0
                       for g in GROUPS}
    pn = float(global_norm([g for g in pgrads.values() if g is not None]))
    jn = float(optax.global_norm(jgrads))
    clip = cfg.trainer.gradient_clipping
    out["grad_norm"] = [jn, pn]
    out["clip_factor"] = [clip / max(jn, clip), clip / max(pn, clip)]
    grads = [torch.zeros_like(p) if pgrads[n] is None else pgrads[n]
             for n, p in zip(names, state.module.parameters())]
    pt.apply_gradients(state, grads)
    after = state.module.state_dict()
    num = {g: 0.0 for g in GROUPS + ("bn_mean", "bn_var")}
    den = dict(num)
    for k, w in jnew.items():
        if k.endswith("num_batches_tracked"):
            continue
        g = ("bn_mean" if k.endswith("running_mean") else "bn_var"
             if k.endswith("running_var") else group_of(k))
        dp = (after[k] - before[k]).double().numpy()
        dj = (w - before[k]).double().numpy()
        num[g] += float(((dp - dj) ** 2).sum())
        den[g] += float((dj ** 2).sum())
    out["update_rel"] = {g: (num[g] / den[g]) ** 0.5 if den[g] else 0.0
                         for g in num}
    return out


def run(args):
    torch.set_num_threads(args.threads)
    from loftr_tpu.structs import MatchInput as JaxMatchInput
    from loftr_tpu.train.trainer import Trainer as JaxTrainer
    from loftr_tpu_torch.train.trainer import Trainer
    from loftr_tpu_torch.utils.weights import state_dict_from_jax
    from torch_train_common import jax_select_noise, to_torch

    os.makedirs(args.work_dir, exist_ok=True)
    data_dir = osp.join(args.work_dir, "data")
    index = osp.join(data_dir, "train_npzs.json")
    if not osp.exists(index):
        train_npzs, _ = _jax_tool().generate_data(
            data_dir, args.train_scenes, 0, args.views, args.img_size,
            args.seed)
        with open(index, "w") as f:
            json.dump(train_npzs, f)
    with open(index) as f:
        train_npzs = json.load(f)
    batches = Batches(data_dir, train_npzs, args.img_size, args.img_resize,
                      args.batch, args.seed)
    jcfg, pcfg = configs(args.steps, args.batch, args.lr, args.seed,
                         args.sampling, args.fine_type)
    jt = JaxTrainer(jcfg, world_size=1, batch_size_per_device=args.batch)
    pt = Trainer(pcfg, world_size=1, batch_size_per_device=args.batch,
                 device="cpu")
    L = (args.img_resize // 8) ** 2
    k_train = pcfg.loftr.match_coarse.train_matches

    snap = osp.join(args.work_dir, "snapshot.pkl")
    rec_path = osp.join(args.work_dir, "records.jsonl")
    records = []
    if args.resume and osp.exists(snap):
        with open(snap, "rb") as f:
            s = pickle.load(f)
        jstate = jax.tree.map(jax.numpy.asarray, s["jax"])
        pstate = pt.init_state(args.seed, state_dict=s["port_module"])
        pstate.optimizer.load_state_dict(s["port_optim"])
        pstate.step = s["step"]
        start = s["step"]
        with open(rec_path) as f:
            records = [json.loads(ln) for ln in f][:start]
        print(f"resumed at step {start}", flush=True)
    else:
        start = 0
        jstate = None
    with open(rec_path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")

    t0 = time.time()
    step = start
    for nb in batches.iterate(start):
        if step >= args.steps:
            break
        jb = JaxMatchInput(**{k: jax.numpy.asarray(v) for k, v in nb.items()})
        if jstate is None:
            jstate = jt.init_state(
                jax.random.PRNGKey(args.seed),
                jax.tree.map(lambda x: x[:1], jb))
            pstate = pt.init_state(args.seed, state_dict=state_dict_from_jax(
                _variables(jstate)))
            if args.port_twin:
                up = lambda v: (torch.nextafter(
                    v, torch.tensor(np.inf, dtype=v.dtype))
                    if v.is_floating_point() and not args.twin_threads
                    else v)
                ptwin = pt.init_state(args.seed, state_dict={
                    k: up(v) for k, v in state_dict_from_jax(
                        _variables(jstate)).items()})
            if args.hybrid:
                hstate = jstate
            if args.jax_twin:
                # every parameter one float32 ulp up: the control of how
                # fast two float32 trajectories part
                twin = jstate.replace(params=jax.tree.map(
                    lambda x: jax.numpy.nextafter(
                        x, jax.numpy.asarray(np.inf, x.dtype)),
                    jstate.params))
        sel = jax.random.split(jstate.rng)[1]
        noise = jax_select_noise(sel, args.batch, L, k_train, args.sampling)
        comps = None
        if step + 1 in args.components:
            comps = components(jt, pt, jstate, nb, noise, args.seed)
        anchor = None
        anchored = (not args.teacher and args.anchor_every
                    and step % args.anchor_every == 0)
        if anchored:
            astate = port_from_jax(pt, jstate, args.seed)
        if args.teacher:
            pstate = port_from_jax(pt, jstate, args.seed)
        t = time.time()
        if args.hybrid:          # the port's gradients, JAX's optimizer
            hstate, hsc = hybrid_step(jt, pt, hstate, nb, noise, args.seed)
        if args.opt_hybrid:      # JAX's gradients, the port's optimizer
            if step == start:
                grad_fn = jax_grad_fn(jt)
            pstate, hsc = opt_hybrid_step(pt, grad_fn, pstate, jb, sel)
        if args.port_twin:       # JAX's draws, without JAX's step
            torch.set_num_threads(args.twin_threads or args.threads)
            ptwin, jsc = pt.train_step(ptwin, to_torch(nb), noise)
            torch.set_num_threads(args.threads)
            jnext = jstate.replace(rng=jax.random.split(jstate.rng)[0])
        else:
            jnext, jsc = jt.train_step(jstate, jb)
            jax.block_until_ready(jnext.params)
        tj = time.time() - t
        tb = to_torch(nb)
        t = time.time()
        if args.jax_twin:
            twin, psc = jt.train_step(twin, jb)
        elif args.hybrid or args.opt_hybrid:
            psc = hsc
        else:
            pstate, psc = pt.train_step(pstate, tb, noise)
        tp = time.time() - t
        if anchored:
            astate, asc = pt.train_step(astate, tb, noise)
            anchor = {"dist": distances(astate.module, jnext),
                      "rel": {k: abs(v - float(np.asarray(jsc[k])))
                              / max(abs(float(np.asarray(jsc[k]))), 1e-30)
                              for k, v in _scalars(asc).items()}}
        js, ps = _scalars(jsc), _scalars(psc)
        rec = {"step": step + 1, "jax": js, "port": ps,
               "rel": {k: abs(ps[k] - js[k]) / max(abs(js[k]), 1e-30)
                       for k in js},
               "dist": distances(pstate.module, jnext, got=(
                   state_dict_from_jax(_variables(twin)) if args.jax_twin
                   else state_dict_from_jax(_variables(hstate))
                   if args.hybrid else None), want=(ptwin.module.state_dict()
                                     if args.port_twin else None)),
               "ms": {"jax": round(1e3 * tj, 1), "port": round(1e3 * tp, 1)}}
        if args.teacher:
            anchor = {"dist": rec["dist"], "rel": rec["rel"]}
        if anchor is not None:
            rec["anchor"] = anchor
        if comps is not None:
            rec["components"] = comps
        records.append(rec)
        with open(rec_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        jstate = jnext
        step += 1
        if step % args.log_every == 0:
            d = rec["dist"]
            print(f"step {step} loss {js['loss']:.5f}/{ps['loss']:.5f} dist "
                  + " ".join(f"{g} {d[g]:.2e}" for g in d)
                  + (" anchor " + " ".join(
                      f"{g} {v:.1e}" for g, v in anchor["dist"].items())
                     if anchor else "")
                  + f" ({time.time() - t0:.0f}s)", flush=True)
        if step % args.chunk == 0 or step >= args.steps:
            with open(snap + ".tmp", "wb") as f:
                pickle.dump({"step": step, "jax": jax.device_get(jstate),
                             "port_module": pstate.module.state_dict(),
                             "port_optim": pstate.optimizer.state_dict()}, f)
            os.replace(snap + ".tmp", snap)
    return summarize(records, args)


def evaluate(args):
    """Both states of the last snapshot on the held-out scenes."""
    from loftr_tpu.train.checkpoint import save_params as jax_save_params
    from loftr_tpu_torch.tools import synthetic_benchmark as port_tool
    from loftr_tpu_torch.utils.weights import state_dict_from_jax
    with open(osp.join(args.work_dir, "snapshot.pkl"), "rb") as f:
        s = pickle.load(f)
    jax_tool = _jax_tool()
    wd = osp.join(args.work_dir, "eval")
    os.makedirs(wd, exist_ok=True)
    # the held-out scenes' seeds do not depend on the number of train scenes
    _, test_idx = jax_tool.generate_data(wd, 0, 3, args.views,
                                         args.img_size, args.seed)
    extra = ({"loftr": {"loss": {"fine_type": args.fine_type}}}
             if args.fine_type else None)
    port_ckpt = osp.join(wd, "ckpt_port")
    torch.save(s["port_module"], port_ckpt)
    jax_ckpt = osp.join(wd, "ckpt_jax")
    jax_save_params(jax_ckpt, _variables(s["jax"]))
    jax_as_port = osp.join(wd, "ckpt_jax_as_port")
    torch.save(state_dict_from_jax(_variables(s["jax"])), jax_as_port)
    env = {"JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": str(args.threads)}
    out = {"step": s["step"],
           "port": port_tool.evaluate_cli(wd, test_idx, port_ckpt,
                                          args.img_resize, extra_env=env,
                                          extra_cfg=extra, device="cpu"),
           "jax": jax_tool.evaluate_cli(wd, test_idx, jax_ckpt,
                                        args.img_resize, extra_env=env,
                                        extra_cfg=extra),
           "jax_by_port_evaluator": port_tool.evaluate_cli(
               wd, test_idx, jax_as_port, args.img_resize, extra_env=env,
               extra_cfg=extra, device="cpu")}
    print(json.dumps(out))
    if args.out:
        os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


def summarize(records, args):
    anchors = [r["anchor"] for r in records if "anchor" in r]

    def worst(rows, key):
        keys = rows[0][key].keys() if rows else ()
        return {k: max(r[key][k] for r in rows) for k in keys}

    out = {"config": {k: v for k, v in vars(args).items()
                      if k not in ("resume", "out")},
           "steps_run": len(records),
           "first_jump": first_jump(records, args.jump),
           "final": records[-1] if records else None,
           "anchor_worst": {"dist": worst(anchors, "dist"),
                            "rel": worst(anchors, "rel")} if anchors
           else None,
           "anchor_steps": len(anchors),
           "per_step": records}
    if args.out:
        os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f)
        print("wrote", args.out)
    print(json.dumps({k: v for k, v in out.items() if k != "per_step"}))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--work-dir", default=osp.join(REPO, "build", "lockstep"))
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--train-scenes", type=int, default=6)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--img-resize", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--sampling", default="per_pair",
                    choices=["per_pair", "global_replacement"])
    ap.add_argument("--fine-type", default=None, choices=["l2", "l2_with_std"],
                    help="loss.fine_type of both (default: the preset's "
                         "l2_with_std)")
    ap.add_argument("--anchor-every", type=int, default=10,
                    help="restart the port from JAX's state every N steps "
                         "for a one-step comparison (0: never)")
    ap.add_argument("--teacher", action="store_true",
                    help="restart the port from JAX's state before every "
                         "step and keep no free-running port (each record "
                         "is then that step's anchor)")
    ap.add_argument("--jax-twin", action="store_true",
                    help="control run: in place of the port, a second JAX "
                         "run from the same init with every parameter one "
                         "float32 ulp up, with the same batches and draws")
    ap.add_argument("--port-twin", action="store_true",
                    help="control run: in place of JAX, a second port run "
                         "from the same init with every parameter one "
                         "float32 ulp up, with JAX's batches and draws")
    ap.add_argument("--twin-threads", type=int, default=0,
                    help="with --port-twin: the twin starts equal and steps "
                         "with this many threads (other summation orders "
                         "every step) instead of starting one ulp up")
    ap.add_argument("--hybrid", action="store_true",
                    help="control run: in place of the port, a run with "
                         "the port's forward, loss, gradients and running "
                         "statistics and JAX's optimizer")
    ap.add_argument("--opt-hybrid", action="store_true",
                    help="control run: in place of the port, a run with "
                         "JAX's forward, loss, gradients and running "
                         "statistics and the port's optimizer")
    ap.add_argument("--components", type=int, nargs="*", default=[],
                    help="steps at which one step from JAX's state is also "
                         "taken apart component by component")
    ap.add_argument("--jump", type=float, default=100.0)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--evaluate", action="store_true",
                    help="evaluate the last snapshot's two states on the "
                         "held-out scenes instead of training")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    evaluate(a) if a.evaluate else run(a)
