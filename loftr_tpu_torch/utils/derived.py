"""Tensors derived from a module's parameters, cached on the module.

Inference casts float32 parameters to the compute dtype, folds eval
BatchNorm into per-channel coefficients and packs encoder weights for the
kernels.  Recomputing them on every call costs a few small launches each,
hundreds per forward, which at batch 1 leave the device idle.  The cache
keys each entry on the source parameters' storage and version counters, so
loading new weights, moving the module or any in-place update rebuilds it.
With autograd on, nothing is cached (the result must carry its graph).
"""
from __future__ import annotations

from typing import Callable, Hashable, Sequence

import torch
import torch.nn as nn


def derived(module: nn.Module, key: Hashable,
            params: Sequence[torch.Tensor], make: Callable):
    """``make()``, cached on ``module`` under ``key`` while ``params``
    are unchanged."""
    if torch.is_grad_enabled():
        return make()
    stamp = tuple((p.data_ptr(), p._version) for p in params)
    cache = module.__dict__.setdefault("_derived_cache", {})
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        hit = (stamp, make())
        cache[key] = hit
    return hit[1]
