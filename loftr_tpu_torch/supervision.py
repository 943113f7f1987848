"""Ground-truth supervision from depth, pose and intrinsics
(``loftr_tpu.supervision``; the reference's supervision.py and geometry.py).

  - :func:`warp_kpts`: unproject with depth, rigid transform, project, with
    nonzero-depth / covisibility / depth-consistency validity masks.
  - :func:`coarse_supervision`: warp the coarse grids both ways, round to
    cells, mutual-nearest by index loop-back; emits the per-row
    :class:`~loftr_tpu_torch.structs.Supervision`.
  - :func:`fine_supervision`: GT offsets normalised to the fine window.

Everything runs in float32 without autograd.  The three 3x3 products of
``warp_kpts`` are written as broadcast sums, so no reduced-precision matmul
mode (TF32) can reach them: a pixel coordinate rounded to three digits lands
in the wrong 8 px coarse cell.
"""
from __future__ import annotations

import torch

from loftr_tpu_torch.structs import CoarseMatches, MatchInput, Supervision


def _sample_depth(depth: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """depth: [B, H, W]; pts: [B, L, 2] (x, y) integer positions (clipped).
    Returns [B, L]."""
    b, h, w = depth.shape
    x = pts[..., 0].clamp(0, w - 1)
    y = pts[..., 1].clamp(0, h - 1)
    return torch.gather(depth.reshape(b, h * w), 1, (y * w + x).long())


def _apply3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """out[b, l, i] = sum_j m[b, i, j] * v[b, l, j], float32 on any device."""
    return (m[:, None, :, :] * v[:, :, None, :]).sum(dim=-1)


@torch.no_grad()
def warp_kpts(kpts0: torch.Tensor, depth0: torch.Tensor, depth1: torch.Tensor,
              T_0to1: torch.Tensor, K0: torch.Tensor, K1: torch.Tensor):
    """Depth-based warp with validity masks.

    kpts0: [B, L, 2] (x, y) in image0 pixels.
    Returns (valid_mask [B, L], w_kpts0 [B, L, 2]).
    """
    kpts0_long = torch.round(kpts0).to(torch.int32)   # half to even, as jnp
    kpts0_depth = _sample_depth(depth0, kpts0_long)
    nonzero_mask = kpts0_depth != 0

    ones = torch.ones_like(kpts0[..., :1])
    kpts0_h = torch.cat([kpts0, ones], dim=-1) * kpts0_depth[..., None]
    kpts0_cam = _apply3(torch.linalg.inv(K0), kpts0_h)

    w_cam = _apply3(T_0to1[:, :3, :3], kpts0_cam) + T_0to1[:, None, :3, 3]
    w_depth_computed = w_cam[..., 2]

    w_h = _apply3(K1, w_cam)
    w_kpts0 = w_h[..., :2] / (w_h[..., 2:3] + 1e-4)

    h, w = depth1.shape[1], depth1.shape[2]
    covisible = (w_kpts0[..., 0] > 0) & (w_kpts0[..., 0] < w - 1) & \
                (w_kpts0[..., 1] > 0) & (w_kpts0[..., 1] < h - 1)
    # truncation toward zero, as astype(int32); non-covisible points (which
    # may be non-finite) are replaced before the cast
    w_long = torch.where(covisible[..., None], w_kpts0,
                         torch.zeros_like(w_kpts0)).to(torch.int32)
    w_depth = _sample_depth(depth1, w_long)
    safe = torch.where(w_depth == 0, torch.ones_like(w_depth), w_depth)
    consistent = (((w_depth - w_depth_computed) / safe).abs() < 0.2) & \
                 (w_depth != 0)
    return nonzero_mask & covisible & consistent, w_kpts0


def _grid_pts(hc: int, wc: int, b: int, device) -> torch.Tensor:
    """[B, hc*wc, 2] (x, y) coarse-cell coordinates, 0-based."""
    ys = torch.arange(hc, dtype=torch.float32, device=device)
    xs = torch.arange(wc, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).reshape(1, hc * wc, 2)
    return grid.expand(b, hc * wc, 2)


def _round_cells(pt: torch.Tensor) -> torch.Tensor:
    """Round to cells as int64; non-finite coordinates (a warp through zero
    depth) become -1, which is out of bounds like any value they would
    cast to."""
    r = torch.round(pt)
    r = torch.where(torch.isfinite(r) & (r.abs() < 2 ** 30), r,
                    torch.full_like(r, -1.0))
    return r.long()


@torch.no_grad()
def coarse_supervision(inp: MatchInput, resolution: int) -> Supervision:
    """Coarse GT.  resolution: coarse stride (normally 8)."""
    B, H0, W0, _ = inp.image0.shape
    _, H1, W1, _ = inp.image1.shape
    h0, w0 = H0 // resolution, W0 // resolution
    h1, w1 = H1 // resolution, W1 // resolution
    L, S = h0 * w0, h1 * w1
    dev = inp.image0.device

    scale0 = resolution if inp.scale0 is None else \
        resolution * inp.scale0[:, None, :]
    scale1 = resolution if inp.scale1 is None else \
        resolution * inp.scale1[:, None, :]

    grid_pt0_i = _grid_pts(h0, w0, B, dev) * scale0
    grid_pt1_i = _grid_pts(h1, w1, B, dev) * scale1

    # zero out padded regions so they warp degenerately
    if inp.mask0 is not None:
        m0 = inp.mask0.reshape(B, L, 1).bool()
        m1 = inp.mask1.reshape(B, S, 1).bool()
        grid_pt0_i = torch.where(m0, grid_pt0_i, torch.zeros_like(grid_pt0_i))
        grid_pt1_i = torch.where(m1, grid_pt1_i, torch.zeros_like(grid_pt1_i))

    # both directions; the validity masks are not used (as the reference)
    _, w_pt0_i = warp_kpts(grid_pt0_i, inp.depth0, inp.depth1, inp.T_0to1,
                           inp.K0, inp.K1)
    _, w_pt1_i = warp_kpts(grid_pt1_i, inp.depth1, inp.depth0, inp.T_1to0,
                           inp.K1, inp.K0)
    w_pt0_r = _round_cells(w_pt0_i / scale1)
    w_pt1_r = _round_cells(w_pt1_i / scale0)

    def in_bounds(pt, w, h):
        return (pt[..., 0] >= 0) & (pt[..., 0] < w) & \
               (pt[..., 1] >= 0) & (pt[..., 1] < h)

    ok0 = in_bounds(w_pt0_r, w1, h1)
    ok1 = in_bounds(w_pt1_r, w0, h0)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    nearest_index1 = torch.where(
        ok0, w_pt0_r[..., 0] + w_pt0_r[..., 1] * w1, zero)   # [B, L]
    nearest_index0 = torch.where(
        ok1, w_pt1_r[..., 0] + w_pt1_r[..., 1] * w0, zero)   # [B, S]

    # mutual check by loop-back
    loop_back = torch.gather(nearest_index0, 1, nearest_index1)
    correct = loop_back == torch.arange(L, device=dev)[None, :]
    correct[:, 0] = False  # ignore the top-left corner

    return Supervision(gt_j=nearest_index1.to(torch.int32), gt_valid=correct,
                       w_pt0_i=w_pt0_i, pt1_i=grid_pt1_i.contiguous())


@torch.no_grad()
def fine_supervision(spv: Supervision, matches: CoarseMatches,
                     inp: MatchInput, resolution_f: int,
                     window: int) -> torch.Tensor:
    """GT fine offsets of the selected matches: expec_f_gt [B, K, 2],
    normalised to [-1, 1] window coordinates."""
    radius = window // 2
    i_ids = matches.i_ids.long()[:, :, None].expand(-1, -1, 2)
    j_ids = matches.j_ids.long()[:, :, None].expand(-1, -1, 2)
    w_pt0 = torch.gather(spv.w_pt0_i, 1, i_ids)   # [B, K, 2]
    pt1 = torch.gather(spv.pt1_i, 1, j_ids)       # [B, K, 2]
    scale = resolution_f if inp.scale1 is None else \
        resolution_f * inp.scale1[:, None, :]
    return (w_pt0 - pt1) / scale / radius
