"""Minimal SO(3)/SE(3) Lie-group utilities, closed form and batched
(``loftr_tpu.sfm.lie``).

Both branches of each small-angle switch are kept as JAX has them: the
series below the switch, the closed form above it at ``max(theta, eps)``,
and ``log_so3``'s cosine clipped to +-(1 - 1e-7)."""
from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], dim=-2)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    """[..., 3, 4] -> [..., 4, 4] with the row (0, 0, 0, 1) below."""
    row = top.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(
        top.shape[:-2] + (4,))[..., None, :]
    return torch.cat([top, row], dim=-2)


def exp_so3(w: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)[..., None]
    W = hat(w)
    W2 = W @ W
    t = torch.clamp(theta, min=eps)
    A = torch.where(theta < eps, 1.0 - theta ** 2 / 6, torch.sin(t) / t)
    B = torch.where(theta < eps, 0.5 - theta ** 2 / 24,
                    (1 - torch.cos(t)) / t ** 2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A * W + B * W2


def log_so3(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3] axis-angle."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1) / 2, -1 + 1e-7, 1 - 1e-7)
    theta = torch.arccos(cos)
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    th = theta[..., None]
    scale = torch.where(th < eps, torch.full_like(th, 0.5),
                        th / (2 * torch.sin(th)))
    return w * scale


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] (w, v) -> [..., 4, 4] rigid transform (rotation-first
    convention; the translation goes through the V matrix)."""
    w, v = xi[..., :3], xi[..., 3:]
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)[..., None]
    W = hat(w)
    W2 = W @ W
    t = torch.clamp(theta, min=1e-8)
    small = theta < 1e-6
    A = torch.where(small, 1.0 - theta ** 2 / 6, torch.sin(t) / t)
    B = torch.where(small, 0.5 - theta ** 2 / 24, (1 - torch.cos(t)) / t ** 2)
    C = torch.where(small, 1.0 / 6 - theta ** 2 / 120, (1 - A) / t ** 2)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    tvec = (V @ v[..., None])[..., 0]
    return _bottom_row(torch.cat([R, tvec[..., None]], dim=-1))


def compose(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    return T1 @ T2


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    return _bottom_row(torch.cat([Rt, ti[..., None]], dim=-1))
