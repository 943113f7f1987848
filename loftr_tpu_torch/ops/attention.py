"""Linear attention (the reference's linear_attention.py:14-47), plain PyTorch.

The plain twin of the coarse-layer and fine-stage kernels, and the body of
the plain ``LoFTREncoderLayer``.  Same numerics as
``loftr_tpu.ops.attention.linear_attention``: the elu+1 feature map, masks
on Q, K and V, the ``/S ... *S`` round trip and a float32 normaliser.

Layout: [B, L, H, D].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def elu_feature_map(x: torch.Tensor) -> torch.Tensor:
    """phi(x) = elu(x) + 1."""
    return F.elu(x) + 1.0


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_mask: torch.Tensor | None = None,
                     kv_mask: torch.Tensor | None = None,
                     eps: float = 1e-6) -> torch.Tensor:
    """q: [B, L, H, D]; k, v: [B, S, H, D]; masks [B, L] / [B, S].
    Returns [B, L, H, D] in q's dtype."""
    Q = elu_feature_map(q)
    K = elu_feature_map(k)
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    if kv_mask is not None:
        m = kv_mask[:, :, None, None].to(K.dtype)
        K = K * m
        v = v * m

    s_len = v.shape[1]
    v_scaled = v / s_len
    f32 = torch.float32
    # float32 accumulation of bf16 operands, rounded where JAX rounds
    kv = torch.einsum("bshd,bshv->bhdv", K.to(f32), v_scaled.to(f32))
    k_sum = K.to(f32).sum(dim=1)                              # [B, H, D]
    z = 1.0 / (torch.einsum("blhd,bhd->blh", Q.to(f32), k_sum) + eps)
    qkv = torch.einsum("blhd,bhdv->blhv", Q.to(f32),
                       kv.to(q.dtype).to(f32))
    out = qkv * z[..., None] * s_len
    return out.to(q.dtype)
