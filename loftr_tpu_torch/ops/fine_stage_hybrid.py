"""Training-time fused fine stage: kernel forward, recomputed plain backward
(``loftr_tpu.ops.fine_stage_hybrid``).

The fine-stage kernel (``ops/kernels/fine_stage.py``) keeps each window pair
in shared memory through the whole stage and has no backward; neither has
the JAX package's.  This ``torch.autograd.Function`` runs it in the forward,
stores only the windows and the weights, and in the backward recomputes
``fine_stage_plain`` (the same function in PyTorch) and differentiates that.
Compute is kernel forward + plain forward + plain backward; the stored
activations are O(windows).  The cotangent is exact for the recomputed
forward, whose value differs from the kernel's by summation order (and, in
bfloat16, by single rounding flips).

Reached with ``fine.use_pallas_train=True``; off by default.
"""
from __future__ import annotations

import torch

from loftr_tpu_torch.ops.kernels.fine_stage import (EncoderWeights,
                                                    fine_stage_plain,
                                                    fused_fine_stage)

_N = len(EncoderWeights._fields)


class _FineStageHybrid(torch.autograd.Function):

    @staticmethod
    def forward(ctx, win0, win1, nheads, eps, *weights):
        out = fused_fine_stage(win0, win1, EncoderWeights(*weights[:_N]),
                               EncoderWeights(*weights[_N:]), nheads, eps)
        ctx.save_for_backward(win0, win1, *weights)
        ctx.nheads, ctx.eps = nheads, eps
        return out

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = fine_stage_plain(ins[0], ins[1],
                                   EncoderWeights(*ins[2:2 + _N]),
                                   EncoderWeights(*ins[2 + _N:]), ctx.nheads,
                                   ctx.eps)
            grads = torch.autograd.grad(out, ins, g.float())
        return (grads[0], grads[1], None, None, *grads[2:])


def fused_fine_stage_hybrid(win0: torch.Tensor, win1: torch.Tensor,
                            layer0: EncoderWeights, layer1: EncoderWeights,
                            nheads: int, eps: float = 1e-6) -> torch.Tensor:
    """[NB, W2, C] x 2 -> expec_f [NB, 3] float32, differentiable with
    respect to the windows and both layers' weights."""
    return _FineStageHybrid.apply(win0, win1, nheads, eps, *layer0, *layer1)
