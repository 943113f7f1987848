"""LoFTR transformer: interleaved self/cross attention layers, linear or
full.

Same topology, parameter names and numerics as the reference's
``loftr_module/transformer.py`` and ``loftr_tpu.models.transformer`` (the
plain path): bias-free Q/K/V projections, multi-head linear attention,
bias-free merge, LayerNorm, the concat-style FFN ``mlp([x || message])``, a
second LayerNorm and the residual ``x + message``.  ``attention="full"``
takes softmax attention (``ops.attention.full_attention``) in place of the
linear one; ``fused_heads`` and ``fused_window_attn`` then do not apply,
as in the JAX package.

Parameters stay float32 and are cast to the activation dtype at each use;
LayerNorm runs in float32 and casts back, as in the JAX package.

``fused_heads`` selects ``linear_attention_fused_heads`` (the same values in
wide products) while the module is in ``train()`` mode, and in ``eval()``
too with ``fused_heads_eval``: the JAX matcher applies ``coarse.fused_heads``
to the plain coarse stack in both modes and ``fine.fused_heads`` in training
only.  ``fused_window_attn`` (default off, inference) sends the
attention of a layer called without masks on equal-shape ``x`` and
``source`` (the fine stage's windows) through the window-attention kernel
module.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from loftr_tpu_torch.ops.attention import (full_attention, linear_attention,
                                           linear_attention_fused_heads)
from loftr_tpu_torch.ops.packing import pack_rows, unpack_rows
from loftr_tpu_torch.utils.derived import derived


def apply_linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Linear layer in x's dtype (weights cast at use)."""
    params = [m.weight] if m.bias is None else [m.weight, m.bias]
    w, b = derived(m, x.dtype, params, lambda: (
        m.weight.to(x.dtype), None if m.bias is None else m.bias.to(x.dtype)))
    return F.linear(x, w, b)


def layer_norm_f32(m: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in float32; returns float32."""
    return F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps)


class LoFTREncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, fused_heads: bool = False,
                 fused_window_attn: bool = False,
                 fused_heads_eval: bool = False, attention: str = "linear"):
        super().__init__()
        if attention not in ("linear", "full"):
            raise ValueError(f"attention {attention!r}")
        self.attention = attention
        self.nhead = nhead
        self.d_model = d_model
        self.fused_heads = fused_heads
        self.fused_heads_eval = fused_heads_eval
        self.fused_window_attn = fused_window_attn
        self.q_proj = nn.Linear(d_model, d_model, bias=False)
        self.k_proj = nn.Linear(d_model, d_model, bias=False)
        self.v_proj = nn.Linear(d_model, d_model, bias=False)
        self.merge = nn.Linear(d_model, d_model, bias=False)
        self.mlp = nn.Sequential(
            nn.Linear(2 * d_model, 2 * d_model, bias=False), nn.ReLU(),
            nn.Linear(2 * d_model, d_model, bias=False))
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def _attention(self):
        if self.attention == "full":
            return full_attention
        if self.fused_heads and (self.training or self.fused_heads_eval):
            return linear_attention_fused_heads
        return linear_attention

    def forward(self, x, source, x_mask: Optional[torch.Tensor] = None,
                source_mask: Optional[torch.Tensor] = None, attn=None):
        """x: [B, L, C]; source: [B, S, C]; masks [B, L] / [B, S].
        ``attn``: an attention function with ``linear_attention``'s
        signature in place of the layer's own (the sequence-parallel ones
        of ``parallel/seq_attention.py``)."""
        b, l, c = x.shape
        h = self.nhead
        d = c // h
        q = apply_linear(self.q_proj, x)
        k = apply_linear(self.k_proj, source)
        v = apply_linear(self.v_proj, source)
        if attn is None and (self.fused_window_attn
                and self.attention == "linear"
                and x_mask is None and source_mask is None
                and x.shape == source.shape):
            from loftr_tpu_torch.ops.kernels.window_attention import \
                window_linear_attention
            message = window_linear_attention(q, k, v, nheads=h)
        else:
            if attn is None:
                attn = self._attention()
            message = attn(q.reshape(b, l, h, d), k.reshape(b, -1, h, d),
                           v.reshape(b, -1, h, d), q_mask=x_mask,
                           kv_mask=source_mask)
        message = apply_linear(self.merge, message.reshape(b, l, c))
        message = layer_norm_f32(self.norm1, message).to(x.dtype)
        y = torch.cat([x, message], dim=-1)
        y = F.relu(apply_linear(self.mlp[0], y))
        y = apply_linear(self.mlp[2], y)
        y = layer_norm_f32(self.norm2, y).to(x.dtype)
        return x + y


def run_layers(layers: Sequence, layer_names: Sequence[str], layer_fn,
               feat0, feat1, mask0=None, mask1=None,
               batch_packing: str = "concat"):
    """Apply the named self/cross sequence with ``layer_fn(layer, x, src,
    x_mask, src_mask)``.  'self' packs both images into one call when their
    shapes (and mask presence) agree; 'cross' is sequential: feat1 attends
    to the already-updated feat0 (the reference's transformer.py:96-97)."""
    same_shape = feat0.shape == feat1.shape
    masks_same = (mask0 is None) == (mask1 is None)
    for layer, name in zip(layers, layer_names):
        if name == "self":
            if same_shape and masks_same:
                feat = pack_rows(feat0, feat1, batch_packing)
                m = (None if mask0 is None
                     else pack_rows(mask0, mask1, batch_packing))
                feat = layer_fn(layer, feat, feat, m, m)
                feat0, feat1 = unpack_rows(feat, batch_packing)
            else:
                feat0 = layer_fn(layer, feat0, feat0, mask0, mask0)
                feat1 = layer_fn(layer, feat1, feat1, mask1, mask1)
        elif name == "cross":
            feat0 = layer_fn(layer, feat0, feat1, mask0, mask1)
            feat1 = layer_fn(layer, feat1, feat0, mask1, mask0)
        else:
            raise KeyError(name)
    return feat0, feat1


class LocalFeatureTransformer(nn.Module):
    """A named sequence of 'self'/'cross' encoder layers (plain path),
    with linear or full attention."""

    def __init__(self, d_model: int, nhead: int, layer_names: Sequence[str],
                 attention: str = "linear", fused_heads: bool = False,
                 fused_window_attn: bool = False,
                 fused_heads_eval: bool = False):
        super().__init__()
        self.attention = attention
        self.d_model = d_model
        self.nhead = nhead
        self.layer_names = tuple(layer_names)
        self.layers = nn.ModuleList(
            [LoFTREncoderLayer(d_model, nhead, fused_heads, fused_window_attn,
                               fused_heads_eval, attention)
             for _ in self.layer_names])

    def forward(self, feat0, feat1, mask0=None, mask1=None,
                batch_packing: str = "concat", attn=None):
        """feat0: [B, L, C]; feat1: [B, S, C].  ``attn``: every layer's
        attention function in place of its own (``LoFTREncoderLayer``)."""
        return run_layers(self.layers, self.layer_names,
                          lambda layer, x, s, xm, sm: layer(x, s, xm, sm,
                                                            attn=attn),
                          feat0, feat1, mask0, mask1, batch_packing)
