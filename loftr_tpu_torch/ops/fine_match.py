"""Fine-level matching: centre-vs-window soft-argmax (plain PyTorch).

``fine_match`` is the plain twin of the fine-stage kernel's epilogue
(``loftr_tpu.ops.fine_match``): heatmap = softmax(<center0, window1> /
sqrt(C)), coords = E[grid], std = sum over axes of sqrt(Var).
"""
from __future__ import annotations

import torch


def normalized_grid(w: int, device=None) -> torch.Tensor:
    """[W*W, 2] (x, y) grid normalised to [-1, 1]."""
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1).reshape(w * w, 2)


def fine_match(feat_f0: torch.Tensor, feat_f1: torch.Tensor) -> torch.Tensor:
    """feat_f0, feat_f1: [B, K, WW, C].  Returns expec_f [B, K, 3] float32."""
    _, _, ww, c = feat_f0.shape
    w = int(round(ww ** 0.5))
    center0 = feat_f0[:, :, ww // 2, :]
    sim = torch.einsum("bkc,bkrc->bkr", center0.float(), feat_f1.float())
    heatmap = torch.softmax(sim / c ** 0.5, dim=-1)
    grid = normalized_grid(w, feat_f0.device)
    coords = torch.einsum("bkr,rd->bkd", heatmap, grid)
    e2 = torch.einsum("bkr,rd->bkd", heatmap, grid ** 2)
    std = (e2 - coords ** 2).clamp_min(1e-10).sqrt().sum(dim=-1)
    return torch.cat([coords, std[..., None]], dim=-1)


def fine_kpts(expec_f: torch.Tensor, mkpts0_c: torch.Tensor,
              mkpts1_c: torch.Tensor, window: int, stride_f: int,
              scale1: torch.Tensor | None = None):
    """mkpts1_f = mkpts1_c + coords * (W//2) * stride_f [* scale1];
    mkpts0_f is mkpts0_c, as in the reference."""
    delta = expec_f[..., :2] * (window // 2) * stride_f
    if scale1 is not None:
        delta = delta * scale1[:, None, :]
    return mkpts0_c, mkpts1_c + delta
