"""Seeded random weights, made on the device in a few large draws.

Both sides take the same state dict: the port loads it (as it is, or
through its own inference transforms), the plain reference reads it as it
is.  Families as the port's initialiser draws them: convolutions
variance-scaling (2, fan out) truncated at two deviations (``fmod``
folds the tails back in), linears Xavier uniform, biases zero, norms at
identity.  BatchNorm running statistics are drawn too (means N(0, 0.1),
variances U(0.5, 1.5)), so that folding them into the convolutions is a
real change of the weights.
"""
from __future__ import annotations

import math

import torch

from bench_port.reference.loftr_plain import param_spec


def make_state(widths: dict, seed: int, device) -> dict:
    """The full state dict (float32, BatchNorm counters int64) on
    ``device``, from one generator seeded with ``seed``."""
    spec = param_spec(widths)
    g = torch.Generator(device=device).manual_seed(int(seed))
    numel = lambda s: math.prod(s) if s else 1
    sizes = {}
    for _, shape, kind in spec:
        sizes[kind] = sizes.get(kind, 0) + numel(shape)
    normal = torch.randn(sizes.get("conv", 0) + sizes.get("bn_mean", 0),
                         generator=g, device=device)
    uniform = torch.rand(sizes.get("linear", 0) + sizes.get("bn_var", 0),
                         generator=g, device=device)
    state, at_n, at_u = {}, 0, 0
    for name, shape, kind in spec:
        n = numel(shape)
        if kind == "conv":
            std = math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])) \
                / 0.87962566103423978
            t = torch.fmod(normal[at_n:at_n + n], 2.0) * std
            at_n += n
        elif kind == "bn_mean":
            t = normal[at_n:at_n + n] * 0.1
            at_n += n
        elif kind == "linear":
            a = math.sqrt(6.0 / (shape[0] + shape[1]))
            t = (uniform[at_u:at_u + n] * 2.0 - 1.0) * a
            at_u += n
        elif kind == "bn_var":
            t = uniform[at_u:at_u + n] + 0.5
            at_u += n
        elif kind in ("bn_w", "ln_w"):
            t = torch.ones(n, device=device)
        elif kind == "bn_count":
            state[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        else:
            t = torch.zeros(n, device=device)
        state[name] = t.reshape(shape).clone()
    return state
