"""Optimizer and LR schedule (``loftr_tpu.train.optim``; the reference's
optimizers/__init__.py and the warm-up of lightning_loftr.py:60-80).

``lr_schedule`` is a plain function of the update count, and the trainer
writes its value into the optimizer's ``param_group["lr"]`` before every
update, so there is no scheduler object whose step count could drift from
the optimizer's.  ``clip_by_global_norm`` scales by ``clip / max(norm,
clip)`` as ``optax.clip_by_global_norm`` does
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm).  AdamW decays
every parameter, biases and norm scales included, as ``optax.adamw`` does.
The linear LR scaling rule is applied by the caller (``Config.scaled_lr``).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence

import torch

from loftr_tpu_torch.config import TrainerConfig


def lr_schedule(cfg: TrainerConfig, true_lr: float, warmup_step: int
                ) -> Callable[[int], float]:
    """Returns f(step) -> lr, step counting optimizer updates from 0.

    Warm-up: 'linear' ramps from warmup_ratio*true_lr to true_lr over
    warmup_step steps; 'constant' holds warmup_ratio*true_lr.  Afterwards
    the base scheduler takes over; epoch-interval schedules are driven by
    steps_per_epoch."""
    if cfg.scheduler not in ("MultiStepLR", "CosineAnnealing",
                             "ExponentialLR"):
        raise ValueError(cfg.scheduler)
    if cfg.warmup_type not in ("linear", "constant"):
        raise ValueError(cfg.warmup_type)

    def sched(step: int) -> float:
        if cfg.scheduler_interval == "epoch":
            if cfg.steps_per_epoch <= 0:
                raise ValueError("steps_per_epoch required for "
                                 "epoch-interval schedules")
            t = step // cfg.steps_per_epoch
        else:
            t = step
        if cfg.scheduler == "MultiStepLR":
            factor = cfg.mslr_gamma ** sum(m <= t for m in cfg.mslr_milestones)
        elif cfg.scheduler == "CosineAnnealing":
            factor = 0.5 * (1 + math.cos(math.pi * t / cfg.cosa_tmax))
        else:
            factor = cfg.elr_gamma ** t
        if step >= warmup_step:
            return true_lr * factor
        floor = cfg.warmup_ratio * true_lr
        if cfg.warmup_type == "constant":
            return floor
        return floor + (true_lr - floor) * step / max(warmup_step, 1)

    return sched


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, float32, on their device."""
    grads = list(grads)
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def clip_by_global_norm(grads: Sequence[torch.Tensor], clip: float
                        ) -> torch.Tensor:
    """Scale ``grads`` in place by clip / max(norm, clip); returns the norm
    before clipping."""
    norm = global_norm(grads)
    factor = clip / torch.clamp(norm, min=clip)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm


def build_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainerConfig,
                    true_lr: float) -> torch.optim.Optimizer:
    """Adam (with optional L2 decay added to the gradient) or AdamW.  The
    learning rate is set per update from :func:`lr_schedule`."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=true_lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.adam_decay)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=true_lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.adamw_decay)
    raise ValueError(cfg.optimizer)
