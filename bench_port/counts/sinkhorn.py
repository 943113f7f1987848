"""Operations and bytes of the port's kernel E (Sinkhorn) at a call's
shapes, and the whole-step forward count of a LoFTR-OT pair.

Copied from ``chip_smoke.py`` (kernel E :956-957), which counts the work of
the function at the call's shapes, whatever design computes it: one
[L, S] x C similarity product per iteration, one for the final pass and
one more with ``prefilter``; bytes: both feature maps in bf16, and per row
and column the potentials, best values, indices and flags.
"""
from __future__ import annotations

from bench_port.counts.model_flops import pair_forward


def sinkhorn(B: int, L: int, S: int, C: int = 256, iters: int = 3,
             prefilter: bool = False):
    """Kernel E on B pairs: (flops, bytes)."""
    flops = (iters + 1 + int(prefilter)) * 2 * B * L * S * C
    nbytes = B * ((L + S) * C * 2 + 9 * L + 5 * S)
    return flops, nbytes


def pair_forward_ot(H: int, W: int, K: int, iters: int = 3,
                    d_coarse: int = 256) -> int:
    """Forward FLOPs of one LoFTR-OT pair: ``pair_forward`` (which counts
    one [L, S] product, the final pass) plus one more a Sinkhorn
    iteration."""
    L = (H // 8) * (W // 8)
    return pair_forward(H, W, K) + iters * 2 * L * L * d_coarse
