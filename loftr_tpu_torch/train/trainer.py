"""Training orchestration (``loftr_tpu.train.trainer``): state and the
train / eval / validation steps.

One training step = coarse supervision -> forward (train selection) -> fine
supervision -> loss -> gradients -> clip -> optimizer update (the
reference's lightning_loftr.py:84-93).  PyTorch runs eagerly, so a step is
a plain method; it updates the state's module and optimizer in place and
returns the same state object.  Scalars stay tensors on the device (no host
synchronisation inside a step), except ``lr``.

With ``accum_steps > 1`` the micro-batch gradients are averaged, the
*average* is clipped, the optimizer runs once per ``accum_steps`` steps and
the schedule counts those real updates (``optax.MultiSteps`` semantics).

A model of dtype float32 trains in float32: ``train_step`` turns cuDNN's
and cuBLAS's TF32 off while it runs and gives the previous flags back, as
JAX computes float32 convolutions and products in float32 on the CPU.
PyTorch's default, TF32 convolutions, cost the accuracy benchmark's seed 2
0.021-0.034 auc@20 in each of five inits on the H100 (``PERF.md``).
The bfloat16 path keeps the flags as they are.

Data parallelism (``world_size > 1``, or an explicit ``group``): each
process is a rank with its rows of the global batch, and a step computes
what one process computes on the concatenated global batch, as JAX's step
under a data-sharded mesh does.  Inside ``parallel.comm.data_parallel``
BatchNorm takes the global batch statistics, every loss denominator is
global and the selection draws its noise at the global batch's shape, so
the loss of a rank is its part of the global loss; the parameter
gradients are summed over the ranks (one all-reduce) before the norm and
the clip, and the scalars are the global ones.  Averaging per-rank losses,
as plain DDP does, would weigh each rank's matches by its own counts.  The
module starts from rank 0's state on every rank (``parallel.mesh.
replicate``), and the packing switches to ``interleave`` for
``world_size > 1``, as in JAX.  A group of one rank gives the plain step
bit for bit.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from loftr_tpu_torch.api import resolve_device, with_config
from loftr_tpu_torch.config import Config
from loftr_tpu_torch.losses import loftr_loss
from loftr_tpu_torch.models.matcher import LoFTR
from loftr_tpu_torch.parallel import comm
from loftr_tpu_torch.parallel.mesh import replicate
from loftr_tpu_torch.structs import MatchInput, MatchResult
from loftr_tpu_torch.supervision import coarse_supervision, fine_supervision
from loftr_tpu_torch.train.optim import (build_optimizer, clip_by_global_norm,
                                         global_norm, lr_schedule)
from loftr_tpu_torch.utils.precision import true_float32
from loftr_tpu_torch.utils.profiler import span
from loftr_tpu_torch.utils.weights import init_weights


@dataclass
class TrainState:
    step: int                               # micro-steps taken
    module: LoFTR                           # parameters + running statistics
    optimizer: torch.optim.Optimizer
    generator: torch.Generator              # match-selection randomness
    accum: Optional[List[torch.Tensor]] = None  # running mean of gradients


class Trainer:
    """Owns the configuration, schedule and step functions.

        trainer = Trainer(config)                 # on CUDA unless device="cpu"
        state = trainer.init_state(seed=0)
        state, scalars = trainer.train_step(state, batch)
    """

    def __init__(self, config: Config, world_size: int = 1,
                 batch_size_per_device: int = 1, device="cuda", group=None):
        """world_size > 1 trains data-parallel over ``group`` (the default
        process group when None), which must hold ``world_size`` ranks; a
        ``group`` of one rank runs the data-parallel step on one process."""
        self.group = None
        if world_size > 1 or group is not None:
            if not comm.initialized():
                raise RuntimeError(
                    f"Trainer(world_size={world_size}) needs a process "
                    "group (parallel.mesh.init_process_group)")
            self.group = group or torch.distributed.group.WORLD
            if comm.group_size(self.group) != world_size:
                raise ValueError(
                    f"world_size {world_size} but the group holds "
                    f"{comm.group_size(self.group)} ranks")
        if world_size > 1:
            # shard-local two-image packing, as the JAX Trainer
            config = config.replaced(
                {"loftr": {"batch_packing": "interleave"}})
        self.config = config
        self.device = resolve_device(device)
        self.true_lr, self.warmup_step = config.scaled_lr(
            world_size, batch_size_per_device)
        self._accum = max(1, config.trainer.accum_steps)
        self._lr_sched = lr_schedule(config.trainer, self.true_lr,
                                     self.warmup_step)
        self._res_c, self._res_f = config.loftr.backbone.resolution
        self._window = config.loftr.fine.window_size

    # ---------------------------------------------------------------- init
    def init_state(self, seed: int = 0,
                   state_dict: Optional[dict] = None) -> TrainState:
        """A fresh state: seeded random weights (or ``state_dict``), a new
        optimizer and a generator seeded from ``seed`` on the device."""
        model = LoFTR(self.config.loftr)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            init_weights(model, seed)
        model = model.to(self.device).train()
        if self.group is not None:
            replicate(model, self.group)
        opt = build_optimizer(model.parameters(), self.config.trainer,
                              self.true_lr)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return TrainState(step=0, module=model, optimizer=opt, generator=gen)

    # ---------------------------------------------------------------- step
    def forward_loss(self, state: TrainState, batch: MatchInput,
                     noise: Optional[dict] = None):
        """Supervision, training forward and loss.  Returns (loss, scalars,
        MatchResult)."""
        model = state.module.train()
        with span("train.supervision"):
            spv = coarse_supervision(batch, self._res_c)
        with span("train.forward"):
            out = model(batch, train=True, generator=state.generator,
                        gt_j=spv.gt_j, gt_valid=spv.gt_valid, noise=noise)
        with span("train.loss"):
            expec_f_gt = fine_supervision(spv, out.coarse, batch,
                                          self._res_f, self._window)
            loss, scalars = loftr_loss(out, spv, expec_f_gt, batch,
                                       self.config.loftr.loss,
                                       self.config.loftr.match_coarse)
        return loss, scalars, out

    def apply_gradients(self, state: TrainState,
                        grads: List[torch.Tensor]) -> float:
        """Accumulate, and on a real update clip and step the optimizer.
        Returns the learning rate of the update this micro-step belongs to."""
        k = state.step % self._accum
        lr = self._lr_sched(state.step // self._accum)
        if self._accum > 1:
            if k == 0:
                state.accum = [g.clone() for g in grads]
            else:
                for a, g in zip(state.accum, grads):
                    a.add_((g - a) / (k + 1))
            grads = state.accum
        if k == self._accum - 1:
            clip_by_global_norm(grads, self.config.trainer.gradient_clipping)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            for p, g in zip(state.module.parameters(), grads):
                p.grad = g
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            state.accum = None
        state.step += 1
        return lr

    def train_step(self, state: TrainState, batch: MatchInput,
                   noise: Optional[dict] = None) -> Tuple[TrainState, dict]:
        """One (micro-)step on ``batch``; ``noise`` replaces the generator's
        draws for the match selection (tests).  Its stages run in the spans
        ``train.upload``, ``train.supervision``, ``train.forward`` (the
        ``loftr.*`` spans inside), ``train.loss``, ``train.backward`` and
        ``train.update``."""
        with span("train.upload"):
            batch = batch.to(self.device)
        scope = (contextlib.nullcontext() if self.group is None else
                 comm.data_parallel(self.group, batch.image0.shape[0]))
        with true_float32(self.config.loftr.dtype == "float32"), scope:
            loss, scalars, _ = self.forward_loss(state, batch, noise)
            with span("train.backward"):
                params = list(state.module.parameters())
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params, grads)]
        with span("train.update"):
            scalars = {k: v.detach() for k, v in scalars.items()}
            if self.group is not None:
                # the ranks' parts of the global loss and its gradient
                comm.flat_all_reduce_(grads, self.group)
                names = sorted(scalars)
                total = comm.reduce_sum(
                    torch.stack([scalars[k] for k in names]), self.group)
                scalars = dict(zip(names, total.unbind()))
            scalars["grad_norm"] = global_norm(grads)
            scalars["lr"] = self.apply_gradients(state, grads)
        return state, scalars

    def eval_step(self, state: TrainState, batch: MatchInput) -> MatchResult:
        return state.module.eval()(batch.to(self.device))

    def val_step(self, state: TrainState, batch: MatchInput):
        """Validation: eval-mode forward and the loss on the top-K
        predicted matches (slot masks, no GT padding).  The loss needs the
        confidence matrix, which the matching kernel never forms, so the
        matcher and the fine stage run their plain paths here."""
        batch = batch.to(self.device)
        val_model = with_config(state.module.eval(), {
            "match_coarse": {"use_pallas": False},
            "fine": {"use_pallas": False}})
        spv = coarse_supervision(batch, self._res_c)
        out = val_model(batch)
        expec_f_gt = fine_supervision(spv, out.coarse, batch, self._res_f,
                                      self._window)
        _, scalars = loftr_loss(out, spv, expec_f_gt, batch,
                                self.config.loftr.loss,
                                self.config.loftr.match_coarse)
        return out, scalars
