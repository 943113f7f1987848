"""Kernel F: per-window linear attention in score form.

Replaces ``loftr_tpu/ops/pallas/window_attention.py::window_linear_attention``
(``_window_attn_kernel``).  CUDA source: ``csrc/window_attention.cu``.

For every window and head: ``A = phi(q) phi(k)^T`` with phi = elu + 1
computed in float32 and rounded back to the input dtype, ``z = 1 /
(rowsum(A) + eps)`` from the unrounded float32 scores, ``out = (A rounded to
the input dtype) @ v * z`` with float32 accumulation.  This is linear
attention over the window (``ops.attention.linear_attention`` without
masks).  The score form of the TPU kernel is kept, with its rounding
points; the KV form was not taken.

What bounds it on the H100: bytes, 4 tensors of NB*W2*C values.  In bf16 at
the fine stage's shape (W2 = 25, C = 128, 8 heads) one wave of blocks walks
the windows, one warp a (window, head) on ``mma.sync`` fed by a 2-stage
``cp.async`` ring; every other shape and float32 take one block a window,
one thread a (query row, head) (the source's header note).

``window_linear_attention`` launches the kernel for CUDA tensors and runs
:func:`window_attention_plain` for CPU tensors only; inference only (no
gradient on the CUDA path).  ``window_linear_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from loftr_tpu_torch.ops.kernels import _build
from loftr_tpu_torch.ops.kernels.fine_stage import phi, rnd

MAX_W2 = 32      # kMaxW2 of csrc/window_attention.cu
MAX_HEAD = 32    # kMaxHead


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           nheads: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  q, k, v: [NB, W2, C]."""
    dt = q.dtype
    nb, w2, c = q.shape
    d = c // nheads
    Q = rnd(phi(q), dt).reshape(nb, w2, nheads, d)
    K = rnd(phi(k), dt).reshape(nb, w2, nheads, d)
    V = v.float().reshape(nb, w2, nheads, d)
    s = torch.einsum("nihd,njhd->nhij", Q, K)                  # [N, H, W2, W2]
    z = 1.0 / (s.sum(dim=-1) + eps)                            # [N, H, W2]
    o = torch.einsum("nhij,njhd->nihd", rnd(s, dt), V) \
        * z.permute(0, 2, 1)[..., None]
    return o.reshape(nb, w2, c).to(dt)


def window_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            nheads: int, eps: float = 1e-6) -> torch.Tensor:
    """q, k, v: [NB, W2, C] with C = nheads * dhead, float32 or bfloat16;
    every window attends only within itself.  Returns [NB, W2, C]."""
    if _build.runs_plain("window-attention kernel", q, k, v):
        return window_attention_plain(q, k, v, nheads, eps)
    nb, w2, c = q.shape
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("q, k and v must share shape and dtype")
    if w2 > MAX_W2 or c % nheads or c // nheads > MAX_HEAD \
            or (c // nheads) % 2 or (w2 * c * q.element_size()) % 16:
        raise ValueError(f"window-attention kernel: unsupported W2={w2}, "
                         f"C={c}, nheads={nheads}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("the window-attention kernel is inference only")
    # contiguous and 16-byte aligned: the kernel reads 16 bytes at a time
    q, k, v = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    code = _build.dtype_code(q)
    lib = _build.library()
    out = torch.empty_like(q)
    p = ctypes.c_void_p
    err = lib.loftr_window_attention(
        p(q.data_ptr()), p(k.data_ptr()), p(v.data_ptr()), p(out.data_ptr()),
        nb, w2, c, nheads, eps, code, p(_build.stream_ptr(q)))
    _build.check(err, "loftr_window_attention")
    window_linear_attention.launches += 1
    return out


window_linear_attention.launches = 0
