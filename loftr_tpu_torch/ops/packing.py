"""Two-image batch packing for the same-shape fast paths.

``concat`` is the reference's ``[a; b]`` batch concat; ``interleave``
alternates rows (a[0], b[0], a[1], b[1], ...), which keeps each pair's two
rows together under a batch split.  Every packed op is row-independent, so
both modes give the same results.
"""
from __future__ import annotations

import torch


def pack_rows(a: torch.Tensor, b: torch.Tensor,
              mode: str = "interleave") -> torch.Tensor:
    """[N, ...] x 2 -> [2N, ...]."""
    if mode == "concat":
        return torch.cat([a, b], dim=0)
    return torch.stack([a, b], dim=1).reshape((-1,) + tuple(a.shape[1:]))


def unpack_rows(x: torch.Tensor, mode: str = "interleave"):
    """Inverse of :func:`pack_rows`: [2N, ...] -> ([N, ...], [N, ...])."""
    if mode == "concat":
        a, b = torch.chunk(x, 2, dim=0)
        return a, b
    y = x.reshape((-1, 2) + tuple(x.shape[1:]))
    return y[:, 0], y[:, 1]
