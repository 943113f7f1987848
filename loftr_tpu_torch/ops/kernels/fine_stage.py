"""Kernel C: the fused fine stage (fine transformer + soft-argmax).

Replaces ``loftr_tpu/ops/pallas/fine_stage.py::fused_fine_stage``
(``_fine_stage_kernel``).  CUDA source: ``csrc/fine_stage.cu`` (bfloat16
products: ``csrc/mma_tile.cuh``).

What bounds it on the H100: operations.  A window pair costs about 4
encoder applications x 25 rows x 20*C^2 flop (33 MFLOP at C=128) against
2 x 25 x C input values and 3 output floats.  The windows stay in shared
memory from load to result, so device memory sees one read of the windows
and one [NB, 3] write.  In bfloat16 the products run on ``mma.sync`` with
the weights staged through a ``cp.async`` ring, every epilogue on the
accumulators, and the per-window attention on the tensor cores too; the
kernel can pack up to 3 window pairs a block, and runs one pair a block,
two blocks an SM, the fastest at every window count measured.  It
takes C = 128 with 8 heads (the fine width of every preset).  The float
path, used for the exactness check, keeps one pair a block on the CUDA
cores and takes other widths.

``fused_fine_stage`` launches the kernel for CUDA tensors and runs
:func:`fine_stage_plain` (the same function in PyTorch, rounding where the
JAX kernel rounds) for CPU tensors only.  ``fused_fine_stage.launches``
counts kernel launches.

This module also holds what the coarse-layer kernel shares with it:
``EncoderWeights``, the float32 LayerNorm, ``phi`` and the weight packing.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from loftr_tpu_torch.ops.kernels import _build


class EncoderWeights(NamedTuple):
    """One LoFTREncoderLayer's parameters, float32, [in, out] layout."""
    q: torch.Tensor       # [C, C]
    k: torch.Tensor       # [C, C]
    v: torch.Tensor       # [C, C]
    merge: torch.Tensor   # [C, C]
    ln1_s: torch.Tensor   # [C]
    ln1_b: torch.Tensor   # [C]
    mlp0: torch.Tensor    # [2C, 2C]
    mlp2: torch.Tensor    # [2C, C]
    ln2_s: torch.Tensor   # [C]
    ln2_b: torch.Tensor   # [C]


def layer_norm(x32: torch.Tensor, scale, bias, eps: float = 1e-5):
    """float32 LayerNorm over the last axis, two-pass variance."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale + bias


def phi(x: torch.Tensor) -> torch.Tensor:
    """elu + 1 in float32, in the JAX kernels' where(x > 0, x + 1, exp(x))."""
    x = x.float()
    return torch.where(x > 0, x + 1.0, torch.exp(x))


def rnd(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round a float32 tensor to dt's precision, keeping float32."""
    return x.to(dt).float()


def dot(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """a @ w with both operands in dt and float32 accumulation."""
    return torch.matmul(rnd(a.float(), dt), rnd(w.float(), dt))


def pack_weights(w: EncoderWeights, dt: torch.dtype):
    """(weights in dt: q|k|v|merge|mlp0|mlp2 flattened, LN float32 [4C])."""
    mats = torch.cat([m.reshape(-1) for m in
                      (w.q, w.k, w.v, w.merge, w.mlp0, w.mlp2)]).to(dt)
    ln = torch.cat([w.ln1_s, w.ln1_b, w.ln2_s, w.ln2_b]).float()
    return mats.contiguous(), ln.contiguous()


def _encoder(x, src, w: EncoderWeights, nheads: int, eps: float, dt):
    """One encoder layer on windows.  x, src: [N, W2, C] float32 holding
    dt-rounded values.  Returns the same."""
    n, w2, c = x.shape
    d = c // nheads
    q = rnd(dot(x, w.q, dt), dt)
    k = rnd(dot(src, w.k, dt), dt)
    v = rnd(dot(src, w.v, dt), dt)
    Q = rnd(phi(q), dt).reshape(n, w2, nheads, d)
    K = rnd(phi(k), dt).reshape(n, w2, nheads, d)
    V = v.reshape(n, w2, nheads, d)
    s = rnd(torch.einsum("nihd,njhd->nhij", Q, K), dt)         # [N, H, W2, W2]
    z = 1.0 / (s.sum(dim=-1) + eps)                            # [N, H, W2]
    o = torch.einsum("nhij,njhd->nihd", s, V) * z.permute(0, 2, 1)[..., None]
    msg = rnd(o.reshape(n, w2, c), dt)
    msg = rnd(layer_norm(dot(msg, w.merge, dt), w.ln1_s, w.ln1_b), dt)
    y = rnd(torch.relu(dot(torch.cat([x, msg], dim=-1), w.mlp0, dt)), dt)
    y = rnd(layer_norm(dot(y, w.mlp2, dt), w.ln2_s, w.ln2_b), dt)
    return rnd(x + y, dt)


def fine_stage_plain(win0: torch.Tensor, win1: torch.Tensor,
                     layer0: EncoderWeights, layer1: EncoderWeights,
                     nheads: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the kernel.  win0/win1: [NB, W2, C] in the
    compute dtype.  Returns expec_f rows [NB, 3] (x, y, std), float32."""
    dt = win0.dtype
    nb, w2, c = win0.shape
    x0, x1 = win0.float(), win1.float()
    xs = _encoder(torch.cat([x0, x1]), torch.cat([x0, x1]), layer0, nheads,
                  eps, dt)
    x0, x1 = xs[:nb], xs[nb:]
    x0 = _encoder(x0, x1, layer1, nheads, eps, dt)
    x1 = _encoder(x1, x0, layer1, nheads, eps, dt)

    center = x0[:, w2 // 2, :]                                  # [NB, C]
    sim = (center[:, None, :] * x1).sum(dim=-1) / (c ** 0.5)    # [NB, W2]
    heat = torch.softmax(sim, dim=-1)
    w = int(round(w2 ** 0.5))
    idx = torch.arange(w2, device=win0.device)
    gx = (idx % w).float() / (w - 1) * 2.0 - 1.0
    gy = (idx // w).float() / (w - 1) * 2.0 - 1.0
    cx = (heat * gx).sum(-1)
    cy = (heat * gy).sum(-1)
    vx = ((heat * gx * gx).sum(-1) - cx * cx).clamp_min(1e-10)
    vy = ((heat * gy * gy).sum(-1) - cy * cy).clamp_min(1e-10)
    return torch.stack([cx, cy, vx.sqrt() + vy.sqrt()], dim=-1)


def fused_fine_stage(win0: torch.Tensor, win1: torch.Tensor,
                     layer0: EncoderWeights, layer1: EncoderWeights,
                     nheads: int, eps: float = 1e-6,
                     packed=None) -> torch.Tensor:
    """Fine transformer (self + sequential cross) + soft-argmax.

    win0, win1: [NB, 25, C] windows after the coarse-context merge, float32
    or bfloat16.  ``packed``: optional (``pack_weights(layer0, dt)``,
    ``pack_weights(layer1, dt)``), to skip repacking per call.
    Returns [NB, 3] float32 (x, y, std)."""
    if _build.runs_plain("fine-stage kernel", win0, win1):
        return fine_stage_plain(win0, win1, layer0, layer1, nheads, eps)
    nb, w2, c = win0.shape
    if win1.shape != win0.shape or win1.dtype != win0.dtype:
        raise ValueError("win0 and win1 must share shape and dtype")
    if w2 != 25:
        raise ValueError(f"fine-stage kernel takes 5x5 windows, got W2={w2}")
    if (c % 64 or c % nheads or c > 256 or c // nheads > 32
            or (win0.dtype == torch.bfloat16 and (c, nheads) != (128, 8))):
        raise ValueError(f"fine-stage kernel: unsupported C={c}, "
                         f"nheads={nheads} in {win0.dtype}")
    if not (win0.is_contiguous() and win1.is_contiguous()):
        raise ValueError("fine-stage kernel takes contiguous windows")
    code = _build.dtype_code(win0)
    lib = _build.library()
    if packed is None:
        packed = (pack_weights(layer0, win0.dtype),
                  pack_weights(layer1, win0.dtype))
    (w0, ln0), (w1, ln1) = packed
    for t in (w0, w1):
        if t.dtype != win0.dtype or t.device != win0.device:
            raise ValueError("packed weights must match the windows' dtype "
                             "and device")
    out = torch.empty((nb, 3), dtype=torch.float32, device=win0.device)
    p = ctypes.c_void_p
    err = lib.loftr_fine_stage(
        p(win0.data_ptr()), p(win1.data_ptr()), p(w0.data_ptr()),
        p(ln0.data_ptr()), p(w1.data_ptr()), p(ln1.data_ptr()),
        p(out.data_ptr()), nb, c, nheads, eps, code,
        p(_build.stream_ptr(win0)))
    _build.check(err, "loftr_fine_stage")
    fused_fine_stage.launches += 1
    return out


fused_fine_stage.launches = 0
