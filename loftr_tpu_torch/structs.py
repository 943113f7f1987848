"""Plain dataclasses of tensors: the matcher's inputs and outputs.

Same field names, shapes and layouts as ``loftr_tpu.structs`` (images NHWC,
fixed match capacity K with a validity mask), so the port's results compare
field by field with the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
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
    # supervision and evaluation only
    depth0: Optional[torch.Tensor] = None     # [B, Hd0, Wd0]
    depth1: Optional[torch.Tensor] = None     # [B, Hd1, Wd1]
    T_0to1: Optional[torch.Tensor] = None     # [B, 4, 4]
    T_1to0: Optional[torch.Tensor] = None     # [B, 4, 4]
    K0: Optional[torch.Tensor] = None         # [B, 3, 3]
    K1: Optional[torch.Tensor] = None         # [B, 3, 3]

    def to(self, device) -> "MatchInput":
        """A copy with every tensor on ``device``."""
        return MatchInput(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in fields(self)})


@dataclass
class CoarseMatches:
    """Static-capacity coarse matches."""
    i_ids: torch.Tensor   # [B, K] int32, coarse cell in image0 (l = y*Wc + x)
    j_ids: torch.Tensor   # [B, K] int32, coarse cell in image1
    mconf: torch.Tensor   # [B, K] confidence (0 for GT-padded training slots)
    mask: torch.Tensor    # [B, K] bool, slot holds a real entry
    gt_mask: torch.Tensor  # [B, K] bool, slot was filled from GT padding (train)


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
    conf_matrix_with_bin: Optional[torch.Tensor] = None  # [B, L+1, S+1] (OT sparse)
    feat_c0: Optional[torch.Tensor] = None  # [B, L, C] (fused-loss training:
    feat_c1: Optional[torch.Tensor] = None  # conf is never materialised)

    @property
    def valid(self) -> torch.Tensor:
        """[B, K] slots that are real predicted matches (mconf > 0)."""
        return self.coarse.mask & (self.coarse.mconf > 0)


@dataclass
class Supervision:
    """Coarse and fine ground truth in static shapes.  Row i of image0's
    coarse grid has at most one GT partner (the mutual-nearest
    construction), so GT matches are stored per row."""
    gt_j: torch.Tensor       # [B, L] int32: matched cell in image1 for row i
    gt_valid: torch.Tensor   # [B, L] bool
    w_pt0_i: torch.Tensor    # [B, L, 2] warped grid pts of image0, original px
    pt1_i: torch.Tensor      # [B, S, 2] image1 grid pts, original px

    def conf_matrix_gt(self, S: int) -> torch.Tensor:
        """Dense [B, L, S] bool GT confidence matrix (built on demand)."""
        cols = torch.arange(S, dtype=self.gt_j.dtype, device=self.gt_j.device)
        return (self.gt_j[:, :, None] == cols) & self.gt_valid[:, :, None]

    @property
    def num_gt(self) -> torch.Tensor:
        return self.gt_valid.sum(dim=1)  # [B]
