"""Inference-time channel padding of the ResNet-FPN backbone
(``loftr_tpu.utils.channel_pad`` on the port's state dict).

The reference backbone's middle stage has 196 channels (block_dims (128,
196, 256)).  The JAX package pads it to 256 because TPU lanes come in
128s, so a 196-channel conv pads to 256 lanes inside the TPU anyway.  On
this port's card the convolutions go to cuDNN, and whether 256 channels
beat its 196 is measured by ``chip_smoke.py`` phase 12; nothing here
assumes a gain.

Zero-padding is function-preserving: padded input channels carry zeros,
padded kernel rows and columns are zero, padded BatchNorm channels have
mean 0, var 1, scale 0 and bias 0 and emit 0, and ReLU, LeakyReLU, the
upsample and the residual add all map 0 to 0.  The padded model computes
the function of the (128, 196, 256) one.  Inference only: training would
start to learn the zero channels.

    state = pad_backbone_channels(state)       # 196 -> 256
    cfg = pad_config(cfg)                      # block_dims follow

Composes with ``fold_batchnorm`` in either order.  ``infer_backbone_
overrides`` reads ``norm`` and ``block_dims`` off a state dict, so entry
points take transformed weights without the caller restating the config.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch
import torch.nn.functional as F


def _pad(name: str, x: torch.Tensor, from_dim: int,
         to_dim: int) -> torch.Tensor:
    """Pad every axis of size ``from_dim``; running variances pad with 1."""
    if x.dim() == 0 or from_dim not in x.shape:
        return x
    pad = []
    for d in reversed(x.shape):
        pad += [0, to_dim - d if d == from_dim else 0]
    fill = 1.0 if name.endswith("running_var") else 0.0
    return F.pad(x, pad, value=fill)


def pad_backbone_channels(state: Mapping[str, torch.Tensor],
                          from_dim: int = 196, to_dim: int = 256,
                          prefix: str = "backbone."
                          ) -> Dict[str, torch.Tensor]:
    """Zero-pad every ``from_dim``-sized axis of the backbone's tensors.
    Takes states of every norm (running statistics, GroupNorm affine,
    folded conv biases)."""
    return {k: _pad(k, v, from_dim, to_dim) if k.startswith(prefix) else v
            for k, v in state.items()}


def infer_backbone_overrides(state: Mapping[str, torch.Tensor]) -> dict:
    """``{"backbone": {"norm", "block_dims"}}`` read off a state dict: the
    norm from the stem's ``bn1`` entries (running statistics: batch; an
    affine alone: group; none: folded), the dims from each stage's first
    conv."""
    if "backbone.bn1.running_mean" in state:
        norm = "batch"
    elif "backbone.bn1.weight" in state:
        norm = "group"
    else:
        norm = "none"
    dims = []
    for i in (1, 2, 3, 4):
        w = state.get(f"backbone.layer{i}.0.conv1.weight")
        if w is None:
            break
        dims.append(int(w.shape[0]))
    return {"backbone": {"norm": norm, "block_dims": tuple(dims)}}


def pad_config(cfg, from_dim: int = 196, to_dim: int = 256):
    """A copy of a Config (or ModelConfig) with block_dims' ``from_dim``
    entries at ``to_dim``."""
    def fix(mc):
        dims = tuple(to_dim if d == from_dim else d
                     for d in mc.backbone.block_dims)
        return dataclasses.replace(
            mc, backbone=dataclasses.replace(mc.backbone, block_dims=dims))

    if hasattr(cfg, "loftr"):
        return dataclasses.replace(cfg, loftr=fix(cfg.loftr))
    return fix(cfg)
