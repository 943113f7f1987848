"""Coarse transformer through the coarse-layer kernel module.

Reads the weights of the plain coarse ``LocalFeatureTransformer`` (the same
``loftr_coarse.layers.{i}.*`` parameters) and runs each layer application
through ``ops/kernels/coarse_layer.py``, in the plain stack's order: 'self'
packs both images into one call, 'cross' updates feat0 and then feat1 from
the updated feat0.  Inference only.
"""
from __future__ import annotations

from loftr_tpu_torch.models.fused_fine import encoder_weights, packed_weights
from loftr_tpu_torch.models.transformer import (LocalFeatureTransformer,
                                                run_layers)
from loftr_tpu_torch.ops.kernels.coarse_layer import fused_coarse_layer


def fused_coarse_forward(tr: LocalFeatureTransformer, feat0, feat1,
                         mask0=None, mask1=None,
                         batch_packing: str = "concat"):
    """feat0: [B, L, C]; feat1: [B, S, C] -> both updated."""
    def layer_fn(layer, x, src, xm, sm):
        packed = packed_weights(layer, x.dtype) if x.is_cuda else None
        return fused_coarse_layer(x.contiguous(), src.contiguous(),
                                  encoder_weights(layer), xm, sm,
                                  nheads=tr.nhead, packed=packed)

    return run_layers(tr.layers, tr.layer_names, layer_fn, feat0, feat1,
                      mask0, mask1, batch_packing)
