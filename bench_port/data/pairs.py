"""Seeded image pairs with exact depth, pose and intrinsics, rendered on the
device.

A copy of the port's synthetic scene generator (``data/synthetic.py``:
``HeightfieldScene``, ``make_trajectory``), rewritten in PyTorch so a run
makes its pairs on the card in milliseconds: a Lambertian heightfield
``z = h(x, y)`` textured by multi-octave value noise, both wrap-tiled; each
pixel ray is intersected with the surface by fixed-point iteration, so the
depth is the camera z-depth the supervision warps with.  Cameras look +z
from near the origin with lateral steps of about ``baseline`` and small
rotations.  The same seed gives the same pairs on the same device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def value_noise(g: torch.Generator, n: int, octaves: int, base_res: int,
                device, persistence: float = 0.55) -> torch.Tensor:
    """Smooth value noise in [0, 1], [n, n]: bicubic-upsampled random
    grids, summed over octaves."""
    acc = torch.zeros((n, n), device=device)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        res = base_res * 2 ** o
        if res >= n:
            break
        grid = torch.rand((1, 1, res, res), generator=g, device=device)
        acc += amp * F.interpolate(grid, size=(n, n), mode="bicubic",
                                   align_corners=False)[0, 0]
        total += amp
        amp *= persistence
    acc /= total
    return (acc - acc.min()) / (acc.max() - acc.min() + 1e-9)


def _wrap_bilinear(field: torch.Tensor, px: torch.Tensor,
                   py: torch.Tensor) -> torch.Tensor:
    n = field.shape[0]
    px, py = torch.remainder(px, n), torch.remainder(py, n)
    x0, y0 = px.floor().long(), py.floor().long()
    fx, fy = px - x0, py - y0
    x1, y1 = (x0 + 1) % n, (y0 + 1) % n
    x0, y0 = x0 % n, y0 % n
    return (field[y0, x0] * (1 - fx) * (1 - fy) + field[y0, x1] * fx * (1 - fy)
            + field[y1, x0] * (1 - fx) * fy + field[y1, x1] * fx * fy)


class Scene:
    """Albedo and heightfield, ``extent`` world units a tile."""

    def __init__(self, g: torch.Generator, device, tex_res: int = 1024,
                 field_res: int = 256, extent: float = 8.0, z0: float = 3.0,
                 z_amp: float = 0.45):
        self.texture = value_noise(g, tex_res, 7, 8, device)
        self.height = z0 + z_amp * (
            2.0 * value_noise(g, field_res, 4, 3, device) - 1.0)
        self.extent, self.z0 = extent, z0

    def _sample(self, field, x, y):
        s = field.shape[0] / self.extent
        return _wrap_bilinear(field, x * s, y * s)

    def render(self, K: np.ndarray, c2w: np.ndarray, H: int, W: int,
               iters: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
        """(image [H, W] in [0, 1], depth [H, W]) of one view."""
        dev = self.texture.device
        Kinv = torch.from_numpy(np.linalg.inv(K)).float().to(dev)
        R = torch.from_numpy(c2w[:3, :3]).float().to(dev)
        C = torch.from_numpy(c2w[:3, 3]).float().to(dev)
        v, u = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                              torch.arange(W, device=dev, dtype=torch.float32),
                              indexing="ij")
        d = torch.stack([u, v, torch.ones_like(u)], -1) @ Kinv.t() @ R.t()
        t = (self.z0 - C[2]) / d[..., 2]
        for _ in range(iters):
            t = (self._sample(self.height, C[0] + t * d[..., 0],
                              C[1] + t * d[..., 1]) - C[2]) / d[..., 2]
        img = self._sample(self.texture, C[0] + t * d[..., 0],
                           C[1] + t * d[..., 1])
        return img, t


def _rot(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def trajectory(rng: np.random.Generator, n_views: int, baseline: float = 0.35,
               rot_deg: float = 6.0) -> List[np.ndarray]:
    """cam2world poses: steps of 0.75-1.25 ``baseline``, small rotations."""
    poses, c = [], np.zeros(3)
    for i in range(n_views):
        if i:
            step = rng.standard_normal(3) * [1.0, 0.6, 0.25]
            step *= baseline * (0.75 + 0.5 * rng.random()) / (
                np.linalg.norm(step) + 1e-9)
            c = c + step
        aa = rng.standard_normal(3) * np.deg2rad(rot_deg) / np.sqrt(3)
        T = np.eye(4)
        T[:3, :3] = _rot(aa, float(np.linalg.norm(aa) + 1e-12))
        T[:3, 3] = c
        poses.append(T)
    return poses


@dataclass
class Pairs:
    """``n`` pairs, each padded to ``pad`` (H, W) with coarse masks."""
    image0: torch.Tensor   # [n, H, W] uint8
    image1: torch.Tensor
    depth0: torch.Tensor   # [n, H, W] float32 (0 in the padding)
    depth1: torch.Tensor
    K0: torch.Tensor       # [n, 3, 3]
    K1: torch.Tensor
    T_0to1: torch.Tensor   # [n, 4, 4]
    T_1to0: torch.Tensor
    mask0: torch.Tensor    # [n, H/8, W/8] bool
    mask1: torch.Tensor


def make_pairs(seed: int, n: int, views: Sequence[Sequence[int]],
               pad: Sequence[int], device, views_per_scene: int = 8
               ) -> Pairs:
    """``n`` pairs of consecutive views; pair p takes the view sizes
    ``views[p % len(views)]`` = (H0, W0, H1, W1), each padded bottom-right
    to ``pad``.  Focal length 0.9 x the longer side, principal point at
    the centre."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    rng = np.random.default_rng(int(seed))
    PH, PW = pad
    out = {k: [] for k in Pairs.__dataclass_fields__}
    scene, poses = None, None
    for p in range(n):
        k = p % (views_per_scene - 1)
        if k == 0:
            scene = Scene(g, device)
            poses = trajectory(rng, views_per_scene)
        H0, W0, H1, W1 = views[p % len(views)]
        rec = {}
        for side, (h, w), c2w in (("0", (H0, W0), poses[k]),
                                  ("1", (H1, W1), poses[k + 1])):
            f = 0.9 * max(h, w)
            K = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
            img, depth = scene.render(K, c2w, h, w)
            im = torch.zeros((PH, PW), dtype=torch.uint8, device=device)
            im[:h, :w] = torch.round(img * 255).to(torch.uint8)
            dp = torch.zeros((PH, PW), device=device)
            dp[:h, :w] = depth
            m = torch.zeros((PH // 8, PW // 8), dtype=torch.bool,
                            device=device)
            m[:h // 8, :w // 8] = True
            rec[side] = (im, dp, K, c2w, m)
        T01 = np.linalg.inv(rec["1"][3]) @ rec["0"][3]
        for side in "01":
            out["image" + side].append(rec[side][0])
            out["depth" + side].append(rec[side][1])
            out["K" + side].append(torch.from_numpy(rec[side][2]).float())
            out["mask" + side].append(rec[side][4])
        out["T_0to1"].append(torch.from_numpy(T01).float())
        out["T_1to0"].append(torch.from_numpy(np.linalg.inv(T01)).float())
    return Pairs(**{k: torch.stack(v).to(device) for k, v in out.items()})
