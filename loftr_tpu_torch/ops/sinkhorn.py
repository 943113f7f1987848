"""Log-domain Sinkhorn optimal transport with a learned dustbin
(``loftr_tpu.ops.sinkhorn``; SuperGlue, arXiv:1911.11763, sec. 3.2).

Scores [B, M, N] get a dustbin row and column filled with the scalar
``bin_score``; every real row and column carries mass 1/(M+N), the dustbins
N/(M+N) and M/(M+N); ``iters`` normalisations run in log space (u from the
current v, then v from the new u), and the log coupling is shifted by
+log(M+N) so that a perfect match approaches probability 1.  Plain tensor
functions, differentiable by autograd (OT training uses them).
"""
from __future__ import annotations

import math

import torch


def log_sinkhorn_iterations(z: torch.Tensor, log_mu: torch.Tensor,
                            log_nu: torch.Tensor, iters: int) -> torch.Tensor:
    """z: [B, M, N] log kernel; log_mu: [B, M]; log_nu: [B, N]."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(z + u[:, :, None], dim=1)
    return z + u[:, :, None] + v[:, None, :]


def log_optimal_transport(scores: torch.Tensor, bin_score: torch.Tensor,
                          iters: int) -> torch.Tensor:
    """scores: [B, M, N]; bin_score: scalar tensor (or float).  Returns the
    [B, M+1, N+1] log assignment matrix, dustbins last."""
    b, m, n = scores.shape
    alpha = torch.as_tensor(bin_score, dtype=scores.dtype,
                            device=scores.device)
    couplings = torch.cat([
        torch.cat([scores, alpha.expand(b, m, 1)], dim=2),
        alpha.expand(b, 1, n + 1)], dim=1)

    norm = -math.log(m + n)
    log_mu = scores.new_full((m + 1,), norm)
    log_mu[m] = math.log(n) + norm
    log_nu = scores.new_full((n + 1,), norm)
    log_nu[n] = math.log(m) + norm
    z = log_sinkhorn_iterations(couplings, log_mu.expand(b, m + 1),
                                log_nu.expand(b, n + 1), iters)
    return z - norm
