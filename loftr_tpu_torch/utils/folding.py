"""Inference-time BatchNorm folding of the ResNet-FPN backbone
(``loftr_tpu.utils.folding`` on the port's state dict).

In eval mode every backbone BatchNorm is a per-channel affine with constant
coefficients:

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv'(x) + b',   weight' = weight * gamma / sqrt(var + eps)
                         b'      = beta - mean * gamma / sqrt(var + eps)

``fold_batchnorm`` rewrites a state dict of a ``norm="batch"`` model into
one of the same model built with ``norm="none"`` (``fold_config``): the
BatchNorm entries go and the paired convs gain a bias.  The fold is
computed in float32, as the JAX package's.  Training keeps live BatchNorm;
fold once after training:

    state = fold_batchnorm(matcher.state_dict())
    model = LoFTR(fold_config(cfg).loftr); model.load_state_dict(state)

Whether folding removes time on the card is measured by ``chip_smoke.py``
phase 12 (the backbone's BatchNorm passes against none).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping

import torch

_EPS = 1e-5  # BatchNorm2d's default, as the backbone's Norm
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")


def _paired_conv(bn: str) -> str:
    """A BatchNorm module path -> the conv it follows: ``bn1`` -> ``conv1``,
    ``bn2`` -> ``conv2``, ``downsample.1`` -> ``downsample.0`` and a fusion
    block's ``.1`` -> ``.0``."""
    m = re.fullmatch(r"(.*)\.bn([12])", bn)
    if m:
        return f"{m.group(1)}.conv{m.group(2)}"
    m = re.fullmatch(r"(.*)\.1", bn)
    if m:
        return f"{m.group(1)}.0"
    raise KeyError(f"no conv paired with {bn!r}")


def fold_batchnorm(state: Mapping[str, torch.Tensor],
                   prefix: str = "backbone.") -> Dict[str, torch.Tensor]:
    """Fold the backbone's BatchNorms into conv weight + bias.  Raises
    ``KeyError`` when the backbone has no running statistics (a model not
    built with ``norm="batch"``, or an already folded state)."""
    bns = sorted(k[:-len(".running_mean")] for k in state
                 if k.endswith(".running_mean"))
    outside = [b for b in bns if not b.startswith(prefix)]
    if outside:
        raise ValueError(f"running statistics outside the backbone: "
                         f"{outside}")
    if not bns:
        raise KeyError("no running statistics in the backbone: was the "
                       "model built with norm='batch'?")
    out = dict(state)
    for bn in bns:
        f32 = lambda name: state[f"{bn}.{name}"].to(torch.float32)
        factor = f32("weight") / torch.sqrt(f32("running_var") + _EPS)
        cv = _paired_conv(bn)
        w = state[f"{cv}.weight"].to(torch.float32)
        out[f"{cv}.weight"] = w * factor[:, None, None, None]
        out[f"{cv}.bias"] = f32("bias") - f32("running_mean") * factor
        for name in _BN_FIELDS:
            out.pop(f"{bn}.{name}", None)
    return out


def fold_config(cfg):
    """A copy of a Config (or ModelConfig) with ``backbone.norm="none"``."""
    if hasattr(cfg, "loftr"):
        return cfg.replaced({"loftr": {"backbone": {"norm": "none"}}})
    return dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, norm="none"))
