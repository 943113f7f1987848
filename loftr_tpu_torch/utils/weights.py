"""Weights for the port: reference checkpoints, JAX variables, seeded init.

The port's modules carry the reference LoFTR state_dict key names
(``backbone.layer1.0.conv1.weight``, ``loftr_coarse.layers.3.mlp.0.weight``,
``fine_preprocess.down_proj.bias``, ...), so a released ``.ckpt`` loads
straight in, and :func:`state_dict_from_jax` (the inverse of
``loftr_tpu.utils.weights.convert_torch_state_dict``) turns the JAX
package's ``{'params', 'batch_stats'}`` tree into a port state_dict.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def _conv(w: np.ndarray) -> np.ndarray:
    """[kh, kw, in, out] -> [out, in, kh, kw]."""
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def _linear(w: np.ndarray) -> np.ndarray:
    """[in, out] -> [out, in]."""
    return np.ascontiguousarray(w.T)


def _same(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w)


def _scalar(w: np.ndarray) -> np.ndarray:
    return np.array(w, np.float32).reshape(())


_BN = {("params", "scale"): "weight", ("params", "bias"): "bias",
       ("batch_stats", "mean"): "running_mean",
       ("batch_stats", "var"): "running_var"}
_TX = {"q_proj": "q_proj", "k_proj": "k_proj", "v_proj": "v_proj",
       "merge": "merge", "mlp_0": "mlp.0", "mlp_2": "mlp.2"}
_LN = {"scale": "weight", "bias": "bias"}
_GN = {"scale": "weight", "bias": "bias"}


def _backbone_module(scope: list) -> str:
    """JAX backbone scope (minus the leaf) -> torch module path."""
    head = scope[0]
    m = re.fullmatch(r"layer([1-4])_([01])", head)
    if m:
        stage, blk = m.groups()
        sub = {"conv1": "conv1", "conv2": "conv2", "bn1": "bn1",
               "bn2": "bn2", "downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}[scope[1]]
        return f"layer{stage}.{blk}.{sub}"
    if re.fullmatch(r"layer[1-4]_outconv2", head):
        sub = {"conv1": "0", "bn": "1", "conv2": "3"}[scope[1]]
        return f"{head}.{sub}"
    if head in ("conv1", "bn1") or re.fullmatch(r"layer[1-4]_outconv", head):
        return head
    raise KeyError(head)


def _map_leaf(coll: str, path: list):
    """(collection, JAX path) -> (torch key, transform)."""
    top, leaf = path[0], path[-1]
    if top == "backbone":
        scope = path[1:-1]
        if scope and scope[-1] == "bn":        # Norm(...)/bn/{leaf}
            scope = scope[:-1]
            mod = _backbone_module(scope)
            return f"backbone.{mod}.{_BN[(coll, leaf)]}", _same
        if scope and scope[-1] == "gn" and coll == "params":  # .../gn/{leaf}
            mod = _backbone_module(scope[:-1])
            return f"backbone.{mod}.{_GN[leaf]}", _same
        if coll == "params" and leaf == "kernel":
            return f"backbone.{_backbone_module(scope)}.weight", _conv
        if coll == "params" and leaf == "bias":  # a folded conv's bias
            return f"backbone.{_backbone_module(scope)}.bias", _same
    elif top in ("loftr_coarse", "loftr_fine") and coll == "params":
        i = re.fullmatch(r"layer_(\d+)", path[1]).group(1)
        mod = path[2]
        base = f"{top}.layers.{i}"
        if mod in _TX and leaf == "kernel":
            return f"{base}.{_TX[mod]}.weight", _linear
        if mod in ("norm1", "norm2"):
            return f"{base}.{mod}.{_LN[leaf]}", _same
    elif top in ("down_proj", "merge_feat") and coll == "params":
        if leaf == "kernel":
            return f"fine_preprocess.{top}.weight", _linear
        if leaf == "bias":
            return f"fine_preprocess.{top}.bias", _same
    elif top == "bin_score" and coll == "params":
        return "coarse_matching.bin_score", _scalar
    raise KeyError(leaf)


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` tree (numpy leaves) -> port
    state_dict.  Raises on any leaf it does not map.  BatchNorm layers also
    get ``num_batches_tracked = 0`` so the result loads strictly.  Takes
    every backbone norm: BatchNorm, GroupNorm (``gn`` scale and bias) and
    the folded trees of ``fold_batchnorm`` (conv ``bias``, no
    ``batch_stats``)."""
    out: Dict[str, torch.Tensor] = {}
    for coll in variables:
        if coll not in ("params", "batch_stats"):
            raise KeyError(f"unmapped variable collection {coll!r}")
        for path, val in _leaves(variables[coll]):
            try:
                key, fn = _map_leaf(coll, list(path))
            except (KeyError, AttributeError, IndexError):
                raise KeyError(f"unmapped JAX leaf: {coll}/{'/'.join(path)}")
            out[key] = torch.from_numpy(fn(np.array(val, np.float32)))
            if key.endswith(".running_mean"):
                out[key[:-len("running_mean")] + "num_batches_tracked"] = \
                    torch.tensor(0, dtype=torch.long)
    return out


def load_checkpoint_state(path: str) -> Dict[str, torch.Tensor]:
    """A released reference ``.ckpt`` (a pickle: load trusted files only) ->
    state_dict with the 'matcher.' prefix stripped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("state_dict", ckpt)
    return {k[len("matcher."):] if k.startswith("matcher.") else k: v
            for k, v in state.items()}


def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init with the JAX package's initialiser families:
    convs variance-scaling(2, fan_out, truncated normal), linears Xavier
    uniform with zero bias, norms at identity; the Sinkhorn ``bin_score``
    keeps the configured ``skh_init_bin_score`` it was built with.  The
    numbers differ from JAX's (another generator); only the distributions
    match."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
        elif isinstance(m, nn.Linear):
            nn.init.xavier_uniform_(m.weight, generator=g)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return model
