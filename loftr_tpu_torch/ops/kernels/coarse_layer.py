"""Kernel A: one coarse LoFTREncoderLayer application (linear attention).

Replaces ``loftr_tpu/ops/pallas/coarse_layer.py::fused_coarse_layer``
(``_kv_kernel`` and ``_apply_kernel``).  CUDA source:
``csrc/coarse_layer.cu`` (bfloat16 products: ``csrc/mma_tile.cuh``).

What bounds it on the H100: operations, 20*C^2 flop per row for the
projections and FFN against 2*C bytes of activations in and out, so the
bound is the bf16 tensor-core rate.  The first version reached 2.6% of it:
its WMMA products waited on L2 for the weights at every k-step and staged
every GEMM output through float shared memory.  The bfloat16 passes now run
on ``mma.sync``: the weights stream through a ring of 16 KB k-slabs in
shared memory (``cp.async``, issued ahead of the products, read from L2
once a block), each warp owns one head's 32 columns of every row, and every
epilogue (phi and the normaliser, the attention product itself, ReLU, both
LayerNorms, the residual) runs on the accumulators in registers.  Pass 1
forms per-64-row-tile partials of KV = phi(K)^T (V/S) (per-head diagonal
blocks only: the only blocks the layer uses) and ksum; a second kernel sums
them in a fixed order, because CUDA blocks cannot carry a sum across a grid
the way the TPU's sequential grid does; pass 3 applies the layer to tiles
of 48 rows (when that grid fits one wave of the card's SMs) or 80 rows held
in shared memory, so the [B, L, C] activations cross device memory once
each way.  The float path, used for the exactness
check, runs the same passes on the CUDA cores.  bfloat16 takes C = 256
with 8 heads (the coarse width of every preset).

``fused_coarse_layer`` launches the kernel for CUDA tensors and runs
:func:`coarse_layer_plain` (the same function in PyTorch, rounding where
the JAX kernel rounds) for CPU tensors only.
``fused_coarse_layer.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from loftr_tpu_torch.ops.kernels import _build
from loftr_tpu_torch.ops.kernels.fine_stage import (EncoderWeights, dot,
                                                    layer_norm, pack_weights,
                                                    phi, rnd)

TILE_S = 64  # source rows per KV-partial block (csrc/coarse_layer.cu)


def _mask_f32(mask, b, n, like):
    if mask is None:
        return torch.ones((b, n), dtype=torch.float32, device=like.device)
    return mask.reshape(b, n).to(torch.float32).contiguous()


def coarse_layer_plain(x: torch.Tensor, src: torch.Tensor, w: EncoderWeights,
                       x_mask=None, src_mask=None, nheads: int = 8,
                       eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  x: [B, L, C]; src: [B, S, C];
    masks [B, L] / [B, S] (1 = valid).  Returns [B, L, C] in x's dtype."""
    dt = x.dtype
    B, L, C = x.shape
    S = src.shape[1]
    d = C // nheads
    xm = _mask_f32(x_mask, B, L, x)[:, :, None]
    sm = _mask_f32(src_mask, B, S, x)[:, :, None]

    K = phi(dot(src, w.k, dt)) * sm                      # float, unrounded
    V = dot(src, w.v, dt) * (sm * (1.0 / S))
    kv = torch.einsum("bshd,bshe->bhde", rnd(K, dt).reshape(B, S, nheads, d),
                      rnd(V, dt).reshape(B, S, nheads, d))
    ksum = K.sum(dim=1)                                   # [B, C]

    Q = rnd(phi(dot(x, w.q, dt)) * xm, dt)
    qkv = torch.einsum("blhd,bhde->blhe", Q.reshape(B, L, nheads, d),
                       rnd(kv, dt))
    denom = rnd(Q * ksum[:, None, :], dt).reshape(B, L, nheads, d).sum(-1)
    msg = (qkv * (float(S) / (denom[..., None] + eps))).reshape(B, L, C)
    msg = dot(rnd(msg, dt), w.merge, dt)
    msg = rnd(layer_norm(msg, w.ln1_s, w.ln1_b), dt)
    y = rnd(torch.relu(dot(torch.cat([x.float(), msg], dim=-1), w.mlp0, dt)),
            dt)
    y = layer_norm(dot(y, w.mlp2, dt), w.ln2_s, w.ln2_b)
    return (x.float() + y).to(dt)


def fused_coarse_layer(x: torch.Tensor, src: torch.Tensor, w: EncoderWeights,
                       x_mask=None, src_mask=None, nheads: int = 8,
                       eps: float = 1e-6, packed=None) -> torch.Tensor:
    """One LoFTREncoderLayer application.  ``packed``: optional
    ``pack_weights(w, x.dtype)`` result, to skip repacking per call."""
    if _build.runs_plain("coarse-layer kernel", x, src, x_mask,
                          src_mask):
        return coarse_layer_plain(x, src, w, x_mask, src_mask, nheads, eps)
    B, L, C = x.shape
    S = src.shape[1]
    if src.shape[0] != B or src.shape[2] != C or src.dtype != x.dtype:
        raise ValueError("x and src must share batch, width and dtype")
    if (C % 64 or C % nheads or C > 256
            or (x.dtype == torch.bfloat16 and (C, nheads) != (256, 8))):
        raise ValueError(f"coarse-layer kernel: unsupported C={C}, "
                         f"nheads={nheads} in {x.dtype}")
    if not (x.is_contiguous() and src.is_contiguous()):
        raise ValueError("coarse-layer kernel takes contiguous inputs")
    code = _build.dtype_code(x)
    lib = _build.library()
    wbuf, ln = packed if packed is not None else pack_weights(w, x.dtype)
    if wbuf.dtype != x.dtype or wbuf.device != x.device:
        raise ValueError("packed weights must match x's dtype and device")
    xm = _mask_f32(x_mask, B, L, x)
    sm = _mask_f32(src_mask, B, S, x)
    d = C // nheads
    ntiles = (S + TILE_S - 1) // TILE_S
    # one float scratch buffer: kv_part [B, ntiles, C, d], ks_part
    # [B, ntiles, C], kv [B, C, d], ksum [B, C]
    sizes = (B * ntiles * C * d, B * ntiles * C, B * C * d, B * C)
    kv_part, ks_part, kv, ksum = torch.empty(
        sum(sizes), dtype=torch.float32, device=x.device).split(sizes)
    out = torch.empty_like(x)
    p = ctypes.c_void_p
    err = lib.loftr_coarse_layer(
        p(x.data_ptr()), p(xm.data_ptr()), p(src.data_ptr()),
        p(sm.data_ptr()), p(wbuf.data_ptr()), p(ln.data_ptr()),
        p(kv_part.data_ptr()), p(ks_part.data_ptr()), p(kv.data_ptr()),
        p(ksum.data_ptr()), p(out.data_ptr()), B, L, S, C, nheads, eps, code,
        p(_build.stream_ptr(x)))
    _build.check(err, "loftr_coarse_layer")
    fused_coarse_layer.launches += 1
    return out


fused_coarse_layer.launches = 0
