"""Linear attention (the reference's linear_attention.py:14-47) and full
softmax attention (:56-81), plain PyTorch.

The plain twin of the coarse-layer and fine-stage kernels, and the body of
the plain ``LoFTREncoderLayer``; ``linear_attention_fused_heads`` is the
same function with the heads fused into full-width products (the training
path of the fine transformer).  Same numerics as
``loftr_tpu.ops.attention.linear_attention``: the elu+1 feature map, masks
on Q, K and V, the ``/S ... *S`` round trip and a float32 normaliser.

``full_attention`` is ``loftr_tpu.ops.attention.full_attention``: float32
scores, a softmax over the source, fully masked rows set to zero.  It is
written out, not ``scaled_dot_product_attention``, whose fully masked rows
come out NaN.

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


def linear_attention_fused_heads(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 q_mask: torch.Tensor | None = None,
                                 kv_mask: torch.Tensor | None = None,
                                 eps: float = 1e-6) -> torch.Tensor:
    """:func:`linear_attention` with one [C, C] K^T V product per batch
    entry, masked block-diagonally by head, instead of H products of
    [D, D]: the same values up to summation order, 8x the flop, in wide
    matrix products.  Arguments and result as :func:`linear_attention`."""
    B, L, H, D = q.shape
    C = H * D
    f32 = torch.float32
    Q = elu_feature_map(q)
    K = elu_feature_map(k)
    if q_mask is not None:
        Q = Q * q_mask[:, :, None, None].to(Q.dtype)
    if kv_mask is not None:
        m = kv_mask[:, :, None, None].to(K.dtype)
        K = K * m
        v = v * m

    s_len = v.shape[1]
    Qf = Q.reshape(B, L, C)
    Kf = K.reshape(B, s_len, C)
    Vf = (v / s_len).reshape(B, s_len, C)

    kv_full = torch.einsum("bld,ble->bde", Kf.to(f32), Vf.to(f32))
    d_head = torch.arange(C, device=q.device) // D
    head_bd = d_head[:, None] == d_head[None, :]
    kv_bd = torch.where(head_bd, kv_full, torch.zeros_like(kv_full))
    qkv = torch.einsum("bld,bde->ble", Qf.to(f32), kv_bd.to(q.dtype).to(f32))

    k_sum = Kf.to(f32).sum(dim=1)                               # [B, C]
    denom = (Qf.to(f32) * k_sum[:, None, :]).reshape(B, L, H, D).sum(dim=-1)
    z = 1.0 / (denom + eps)                                     # [B, L, H]
    out = qkv.reshape(B, L, H, D) * z[..., None] * s_len
    return out.to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_mask: torch.Tensor | None = None,
                   kv_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax attention.  q: [B, L, H, D]; k, v: [B, S, H, D]; masks
    [B, L] / [B, S].  Scores in float32; a query row whose pairs are all
    masked gives zeros.  Returns [B, L, H, D] in v's dtype."""
    f32 = torch.float32
    d = q.shape[-1]
    qk = torch.einsum("blhd,bshd->blsh", q.to(f32), k.to(f32))
    masked = q_mask is not None or kv_mask is not None
    if masked:
        qm = (q_mask if q_mask is not None
              else torch.ones(q.shape[:2], dtype=torch.bool, device=q.device))
        kvm = (kv_mask if kv_mask is not None
               else torch.ones(k.shape[:2], dtype=torch.bool,
                               device=k.device))
        pair = qm[:, :, None].bool() & kvm[:, None, :].bool()
        qk = qk.masked_fill(~pair[..., None], float("-inf"))
    attn = torch.softmax(qk / torch.sqrt(torch.tensor(float(d), dtype=f32)),
                         dim=2)
    if masked:
        attn = torch.nan_to_num(attn)
    out = torch.einsum("blsh,bshd->blhd", attn.to(v.dtype).to(f32),
                       v.to(f32))
    return out.to(v.dtype)
