"""Plain dataclasses of tensors: the matcher's inputs and outputs.

Same field names, shapes and layouts as ``loftr_tpu.structs`` (images NHWC,
fixed match capacity K with a validity mask), so the port's results compare
field by field with the JAX package's.  Training supervision is not part of
this slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class MatchInput:
    """One batch of image pairs.  Images are NHWC grayscale in [0, 1]."""
    image0: torch.Tensor                      # [B, H0, W0, 1]
    image1: torch.Tensor                      # [B, H1, W1, 1]
    mask0: Optional[torch.Tensor] = None      # [B, H0/8, W0/8] bool
    mask1: Optional[torch.Tensor] = None      # [B, H1/8, W1/8] bool
    scale0: Optional[torch.Tensor] = None     # [B, 2] (w, h) resize factor
    scale1: Optional[torch.Tensor] = None     # [B, 2]


@dataclass
class CoarseMatches:
    """Static-capacity coarse matches."""
    i_ids: torch.Tensor   # [B, K] int32, coarse cell in image0 (l = y*Wc + x)
    j_ids: torch.Tensor   # [B, K] int32, coarse cell in image1
    mconf: torch.Tensor   # [B, K] confidence
    mask: torch.Tensor    # [B, K] bool, slot holds a real entry
    gt_mask: torch.Tensor  # [B, K] bool, always False at inference


@dataclass
class MatchResult:
    """Full matcher output."""
    coarse: CoarseMatches
    mkpts0_c: torch.Tensor                 # [B, K, 2] (x, y) in original px
    mkpts1_c: torch.Tensor                 # [B, K, 2]
    mkpts0_f: torch.Tensor                 # [B, K, 2] fine-refined
    mkpts1_f: torch.Tensor                 # [B, K, 2]
    expec_f: torch.Tensor                  # [B, K, 3] (x, y, std) in window coords
    conf_matrix: Optional[torch.Tensor] = None   # [B, L, S] (plain matcher only)

    @property
    def valid(self) -> torch.Tensor:
        """[B, K] slots that are real predicted matches (mconf > 0)."""
        return self.coarse.mask & (self.coarse.mconf > 0)
