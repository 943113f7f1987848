"""Kernel E: fused Sinkhorn-OT matching statistics, no [L+1, S+1] matrix.

Replaces ``loftr_tpu/ops/pallas/sinkhorn.py::fused_sinkhorn_match``
(``_u_kernel``, ``_ot_best_kernel``, ``_ot_best_filtered_kernel``).  CUDA
source: ``csrc/sinkhorn.cu``.

What it computes: ``iters`` log-space Sinkhorn iterations on
``sim = <f0, f1> / C`` (masked pairs at -1e9) with a dustbin row and column
at ``bin_score``, then, from ``conf = exp(sim + u + v + log(L+S))``, each
row's best value and first argmax, each column's maximum, and the flags of
rows / columns whose largest assignment entry is the dustbin.  With
``prefilter`` the best values are taken once more over ``conf`` with the
flagged rows and columns zeroed.

What bounds it on the H100: operations.  The least work is one sim product
(2*L*S*C flop) per iteration, one for the final pass and one more with
``prefilter``, against (L+S)*C input values.  The kernel recomputes sim
tiles in every pass instead of holding the coupling matrix; an iteration
takes two passes, since a row's new ``u`` needs all of its columns before
any column statistic of ``sim + u`` can be formed.  Statistics come out as
per-chunk partials that small kernels combine in a fixed order; the
dustbin's closed forms are block reductions.  ``bin_score`` and every
running scalar stay on the device.

bfloat16 features (C = 256) go to the ``mma.sync`` path on kernel B's
pattern: 128 resident rows, 128-row tiles of the other side through a
``cp.async`` ring, epilogues on the accumulators.  Its column pass is the
row pass with the operands swapped, so :func:`sinkhorn_plan` gives a plan
for each orientation.  float32 features go to the 64x64 tile kernel (the
exactness check).

``fused_sinkhorn_match`` launches the kernel for CUDA tensors and runs
:func:`sinkhorn_plain` (which materialises sim) for CPU tensors only.
``fused_sinkhorn_match.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from loftr_tpu_torch.ops.kernels import _build
from loftr_tpu_torch.ops.kernels.dual_softmax import (BF16_C, NEG, TILE,
                                                      _chunk_tiles,
                                                      _mask_vectors, _sm_count,
                                                      bf16_plan)


def sinkhorn_plain(feat0: torch.Tensor, feat1: torch.Tensor,
                   bin_score: torch.Tensor, iters: int = 3,
                   mask0: Optional[torch.Tensor] = None,
                   mask1: Optional[torch.Tensor] = None,
                   prefilter: bool = False, with_conf: bool = False):
    """Plain PyTorch version of the kernel (materialises [B, L, S]): the
    same iterations with the dustbin row and column in closed form.
    ``with_conf`` appends what a comparison needs to tell a near-tie from a
    fault: the conf matrix the best values were taken over, and the margins
    ``alpha + v_bin - max_j(sim + v)`` [B, L] and ``alpha + u_bin -
    max_i(sim + u)`` [B, S] whose signs are the prefilter flags."""
    B, L, C = feat0.shape
    S = feat1.shape[1]
    dev = feat0.device
    alpha = torch.as_tensor(bin_score, dtype=torch.float32,
                            device=dev).detach().reshape(())
    m0, m1 = _mask_vectors(B, L, S, mask0, mask1, dev)
    sim = torch.matmul(feat0.float(), feat1.float().transpose(1, 2)) \
        * (1.0 / C)
    sim = sim + (m0[:, :, None] * m1[:, None, :] - 1.0) * (-NEG)

    norm = -math.log(L + S)
    log_mu_bin = math.log(S) + norm
    log_nu_bin = math.log(L) + norm
    u = sim.new_zeros((B, L))
    v = sim.new_zeros((B, S))
    u_bin = sim.new_zeros((B,))
    v_bin = sim.new_zeros((B,))

    def lse_with(x, extra):         # logsumexp over [x_0 .. x_n, extra]
        return torch.logsumexp(torch.cat([x, extra[:, None]], dim=1), dim=1)

    for _ in range(iters):
        u_bin = log_mu_bin - (alpha + lse_with(v, v_bin))
        row_lse = torch.logsumexp(sim + v[:, None, :], dim=2)
        u = norm - torch.logaddexp(row_lse, (alpha + v_bin)[:, None])
        col_lse = torch.logsumexp(sim + u[:, :, None], dim=1)
        v = norm - torch.logaddexp(col_lse, (alpha + u_bin)[:, None])
        v_bin = log_nu_bin - (alpha + lse_with(u, u_bin))

    conf = torch.exp(sim + u[:, :, None] + v[:, None, :] - norm)
    rowlog = (sim + v[:, None, :]).amax(dim=2)
    collog = (sim + u[:, :, None]).amax(dim=1)
    prefilter0 = (alpha + v_bin)[:, None] > rowlog
    prefilter1 = (alpha + u_bin)[:, None] > collog
    if prefilter:
        conf = conf * (~prefilter0).float()[:, :, None] \
            * (~prefilter1).float()[:, None, :]
    best_val = conf.amax(dim=2)
    best_j = conf.argmax(dim=2)     # first maximum, as jnp.argmax
    out = (best_val, best_j.to(torch.int32), conf.amax(dim=1), prefilter0,
           prefilter1)
    if with_conf:
        out += (conf, (alpha + v_bin)[:, None] - rowlog,
                (alpha + u_bin)[:, None] - collog)
    return out


def sinkhorn_plan(B: int, L: int, S: int, sms: int = 132):
    """Launch plans of the bfloat16 path, one an orientation:
    ``bf16_plan(B, L, S)`` for the row and best passes (f0 resident, f1
    streamed) and ``bf16_plan(B, S, L)`` for the column pass (f1 resident,
    f0 streamed), each (rows, cols, chunk_tiles, nrt, nch).  The kernel is
    built for the default 128 x 128 tile, so only the chunks reach it."""
    return bf16_plan(B, L, S, sms), bf16_plan(B, S, L, sms)


def _launch_bf16(feat0, feat1, alpha, iters, mask0, mask1, prefilter):
    B, L, C = feat0.shape
    S = feat1.shape[1]
    if C != BF16_C:
        raise ValueError(f"Sinkhorn kernel: bfloat16 takes C={BF16_C}, "
                         f"got C={C}")
    if feat0.data_ptr() % 16 or feat1.data_ptr() % 16:
        raise ValueError("Sinkhorn kernel: bfloat16 features must be "
                         "16-byte aligned")
    dev = feat0.device
    (_, _, ct, nrt, nch), (_, _, ctc, _, nchc) = sinkhorn_plan(
        B, L, S, _sm_count(dev.index))
    m0 = m1 = None
    if mask0 is not None or mask1 is not None:
        m0, m1 = _mask_vectors(B, L, S, mask0, mask1, dev)
    # u, v, u_bin, v_bin (zeroed: the starting potentials); pa, pb, pc
    # [B, nch, L]; qa, qb [B, nchc, S]; cpa [B, nrt, S]; keep0, keep1
    sizes = (B * L, B * S, B, B, *(B * nch * L,) * 3, *(B * nchc * S,) * 2,
             B * nrt * S, B * L, B * S)
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    buf[:B * (L + S + 2)].zero_()
    best_val = torch.empty((B, L), dtype=torch.float32, device=dev)
    best_j = torch.empty((B, L), dtype=torch.int32, device=dev)
    colconf = torch.empty((B, S), dtype=torch.float32, device=dev)
    prefilter0 = torch.empty((B, L), dtype=torch.bool, device=dev)
    prefilter1 = torch.empty((B, S), dtype=torch.bool, device=dev)
    p = ctypes.c_void_p
    ptrs = [p(None if t is None else t.data_ptr()) for t in (
        feat0, feat1, m0, m1, alpha, *buf.split(sizes), best_val, best_j,
        colconf, prefilter0, prefilter1)]
    err = _build.library().loftr_sinkhorn_bf16(
        *ptrs, B, L, S, C, ct, ctc, int(iters),
        int(bool(prefilter)), 1.0 / C, p(_build.stream_ptr(feat0)))
    _build.check(err, "loftr_sinkhorn_bf16")
    return best_val, best_j, colconf, prefilter0, prefilter1


def fused_sinkhorn_match(feat0: torch.Tensor, feat1: torch.Tensor,
                         bin_score: torch.Tensor, iters: int = 3,
                         mask0: Optional[torch.Tensor] = None,
                         mask1: Optional[torch.Tensor] = None,
                         prefilter: bool = False):
    """feat0: [B, L, C], feat1: [B, S, C] raw transformer outputs (the 1/C
    scaling is applied to the float dot here); bin_score: scalar tensor;
    mask0 [B, L] / mask1 [B, S] optional.  Inference only (no gradient).

    Returns (best_val [B, L] float32, best_j [B, L] int32, colconf [B, S]
    float32, prefilter0 [B, L] bool, prefilter1 [B, S] bool); with
    ``prefilter`` the first three are taken over the coupling with the
    flagged rows and columns zeroed."""
    if _build.runs_plain("Sinkhorn kernel", feat0, feat1, mask0,
                          mask1):
        return sinkhorn_plain(feat0, feat1, bin_score, iters, mask0, mask1,
                              prefilter)
    B, L, C = feat0.shape
    S = feat1.shape[1]
    if feat1.shape[0] != B or feat1.shape[2] != C or feat1.dtype != feat0.dtype:
        raise ValueError("feat0 and feat1 must share batch, width and dtype")
    if not (feat0.is_contiguous() and feat1.is_contiguous()):
        raise ValueError("Sinkhorn kernel takes contiguous features")
    code = _build.dtype_code(feat0)
    dev = feat0.device
    alpha = torch.as_tensor(bin_score, device=dev).detach().to(
        torch.float32).reshape(1).contiguous()
    if code == 1:
        out = _launch_bf16(feat0, feat1, alpha, iters, mask0, mask1,
                           prefilter)
        fused_sinkhorn_match.launches += 1
        return out
    lib = _build.library()
    m0, m1 = _mask_vectors(B, L, S, mask0, mask1, dev)
    ct = _chunk_tiles(B, L, S)
    nrt = math.ceil(L / TILE)
    nch = math.ceil(math.ceil(S / TILE) / ct)
    f32 = dict(dtype=torch.float32, device=dev)
    state = [torch.zeros(shape, **f32)           # u, v, u_bin, v_bin
             for shape in ((B, L), (B, S), (B,), (B,))]
    scratch = [torch.empty(shape, **f32) for shape in (
        (B, nch, L), (B, nch, L), (B, nch, L),   # row partials a, b, c
        (B, nrt, S), (B, nrt, S),                # column partials a, b
        (B, L), (B, S))]                         # keep0, keep1
    best_val = torch.empty((B, L), **f32)
    best_j = torch.empty((B, L), dtype=torch.int32, device=dev)
    colconf = torch.empty((B, S), **f32)
    prefilter0 = torch.empty((B, L), dtype=torch.bool, device=dev)
    prefilter1 = torch.empty((B, S), dtype=torch.bool, device=dev)
    p = ctypes.c_void_p
    ptrs = [p(t.data_ptr()) for t in (
        feat0, feat1, m0, m1, alpha, *state, *scratch, best_val, best_j,
        colconf, prefilter0, prefilter1)]
    err = lib.loftr_sinkhorn(*ptrs, B, L, S, C, ct, int(iters),
                             int(bool(prefilter)), 1.0 / C, code,
                             p(_build.stream_ptr(feat0)))
    _build.check(err, "loftr_sinkhorn")
    fused_sinkhorn_match.launches += 1
    return best_val, best_j, colconf, prefilter0, prefilter1


fused_sinkhorn_match.launches = 0
