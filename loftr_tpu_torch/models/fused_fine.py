"""Fine transformer + fine matching through the fine-stage kernel module.

Reads the weights of the plain fine ``LocalFeatureTransformer`` (the same
``loftr_fine.layers.{i}.*`` parameters, so one checkpoint drives either
path) and runs ``ops/kernels/fine_stage.py`` instead of the layer stack plus
``fine_match``; with ``trainable`` it goes through the autograd function of
``ops/fine_stage_hybrid.py`` (kernel forward, recomputed plain backward).
The reference fine topology only.
"""
from __future__ import annotations

import torch

from loftr_tpu_torch.models.transformer import (LocalFeatureTransformer,
                                                LoFTREncoderLayer)
from loftr_tpu_torch.ops.fine_stage_hybrid import fused_fine_stage_hybrid
from loftr_tpu_torch.ops.kernels.fine_stage import (EncoderWeights,
                                                    fused_fine_stage,
                                                    pack_weights)
from loftr_tpu_torch.utils.derived import derived


def packed_weights(layer: LoFTREncoderLayer, dtype: torch.dtype):
    """``pack_weights`` of the layer for the kernels, cached per dtype."""
    return derived(layer, ("packed", dtype), list(layer.parameters()),
                   lambda: pack_weights(encoder_weights(layer), dtype))


def encoder_weights(layer: LoFTREncoderLayer) -> EncoderWeights:
    """An encoder layer's parameters in [in, out] layout (views)."""
    return EncoderWeights(
        q=layer.q_proj.weight.t(), k=layer.k_proj.weight.t(),
        v=layer.v_proj.weight.t(), merge=layer.merge.weight.t(),
        ln1_s=layer.norm1.weight, ln1_b=layer.norm1.bias,
        mlp0=layer.mlp[0].weight.t(), mlp2=layer.mlp[2].weight.t(),
        ln2_s=layer.norm2.weight, ln2_b=layer.norm2.bias)


def fused_fine_forward(tr: LocalFeatureTransformer, win0: torch.Tensor,
                       win1: torch.Tensor,
                       trainable: bool = False) -> torch.Tensor:
    """win0, win1: [B, K, W2, C] -> expec_f [B, K, 3] float32."""
    if tr.layer_names != ("self", "cross"):
        raise ValueError("the fine-stage kernel implements the reference "
                         "topology ('self', 'cross') only")
    if tr.attention != "linear":
        raise ValueError("the fine-stage kernel implements linear "
                         "attention only: set fine.use_pallas False for "
                         "fine.attention 'full'")
    b, k, w2, c = win0.shape
    if trainable:
        expec = fused_fine_stage_hybrid(
            win0.reshape(b * k, w2, c).contiguous(),
            win1.reshape(b * k, w2, c).contiguous(),
            encoder_weights(tr.layers[0]), encoder_weights(tr.layers[1]),
            nheads=tr.nhead)
        return expec.reshape(b, k, 3)
    packed = None
    if win0.is_cuda:
        packed = tuple(packed_weights(layer, win0.dtype)
                       for layer in tr.layers)
    expec = fused_fine_stage(
        win0.reshape(b * k, w2, c).contiguous(),
        win1.reshape(b * k, w2, c).contiguous(),
        encoder_weights(tr.layers[0]), encoder_weights(tr.layers[1]),
        nheads=tr.nhead, packed=packed)
    return expec.reshape(b, k, 3)
