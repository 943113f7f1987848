"""MegaDepth pair dataset (host-side numpy).

A copy of ``loftr_tpu.data.megadepth`` (the reference's
src/datasets/megadepth.py:11-127): one scene-npz
per instance; pairs filtered by overlap score; images longer-edge resized,
floored to df-divisible, zero-padded bottom-right to square with validity
mask; depth (h5, or the npy that data/synthetic.py writes on request)
padded to 2000^2; poses/intrinsics from scene_info; coarse mask at 1/8 by
nearest-neighbor downsampling.
"""
from __future__ import annotations

import os.path as osp
from typing import Optional

import numpy as np

from loftr_tpu_torch.data.io import read_megadepth_depth, read_megadepth_gray


def _downsample_mask_nearest(mask: np.ndarray, scale: float) -> np.ndarray:
    """Nearest-neighbor downsample of a bool mask (the reference uses
    F.interpolate(mode='nearest'), megadepth.py:119-125)."""
    h, w = mask.shape
    nh, nw = int(h * scale), int(w * scale)
    # torch 'nearest' picks floor(i/scale)
    rows = np.minimum((np.arange(nh) / scale).astype(np.int64), h - 1)
    cols = np.minimum((np.arange(nw) / scale).astype(np.int64), w - 1)
    return mask[rows][:, cols]


class MegaDepthDataset:
    def __init__(self, root_dir: str, npz_path: str, mode: str = "train",
                 min_overlap_score: float = 0.4,
                 img_resize: Optional[int] = None, df: Optional[int] = None,
                 img_padding: bool = False, depth_padding: bool = False,
                 augment_fn=None, coarse_scale: float = 0.125,
                 depth_max_size: int = 2000):
        self.root_dir = root_dir
        self.mode = mode
        self.scene_id = osp.basename(npz_path).split(".")[0]
        if mode == "test" and min_overlap_score != 0:
            min_overlap_score = 0
        scene_info = np.load(npz_path, allow_pickle=True)
        self.image_paths = scene_info["image_paths"]
        self.depth_paths = scene_info["depth_paths"]
        self.intrinsics = scene_info["intrinsics"]
        self.poses = scene_info["poses"]
        self.pair_infos = [p for p in scene_info["pair_infos"]
                           if p[1] > min_overlap_score]
        if mode == "train":
            assert img_resize is not None and img_padding and depth_padding
        self.img_resize = img_resize
        self.df = df
        self.img_padding = img_padding
        # 2000 is the real-MegaDepth bound (megadepth.py:85-89); smaller
        # synthetic scenes (data/synthetic.py) pass their own static size
        self.depth_max_size = depth_max_size if depth_padding else None
        self.augment_fn = augment_fn if mode == "train" else None
        self.coarse_scale = coarse_scale

    def __len__(self):
        return len(self.pair_infos)

    def __getitem__(self, idx):
        (idx0, idx1), overlap_score, _central = self.pair_infos[idx]
        img0, mask0, scale0 = read_megadepth_gray(
            osp.join(self.root_dir, self.image_paths[idx0]),
            self.img_resize, self.df, self.img_padding)
        img1, mask1, scale1 = read_megadepth_gray(
            osp.join(self.root_dir, self.image_paths[idx1]),
            self.img_resize, self.df, self.img_padding)
        if self.mode in ("train", "val"):
            depth0 = read_megadepth_depth(
                osp.join(self.root_dir, self.depth_paths[idx0]),
                pad_to=self.depth_max_size)
            depth1 = read_megadepth_depth(
                osp.join(self.root_dir, self.depth_paths[idx1]),
                pad_to=self.depth_max_size)
        else:
            depth0 = depth1 = np.zeros((0,), np.float32)

        K0 = np.asarray(self.intrinsics[idx0], np.float32).reshape(3, 3).copy()
        K1 = np.asarray(self.intrinsics[idx1], np.float32).reshape(3, 3).copy()
        T0 = np.asarray(self.poses[idx0], np.float64)
        T1 = np.asarray(self.poses[idx1], np.float64)
        T_0to1 = (T1 @ np.linalg.inv(T0)).astype(np.float32)[:4, :4]

        out = {
            "image0": img0, "image1": img1,
            "depth0": depth0, "depth1": depth1,
            "T_0to1": T_0to1,
            "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
            "K0": K0, "K1": K1,
            "scale0": scale0, "scale1": scale1,
            "dataset_name": "MegaDepth",
            "scene_id": self.scene_id,
            "pair_id": idx,
            "pair_names": (str(self.image_paths[idx0]),
                           str(self.image_paths[idx1])),
        }
        if mask0 is not None and self.coarse_scale:
            out["mask0"] = _downsample_mask_nearest(mask0, self.coarse_scale)
            out["mask1"] = _downsample_mask_nearest(mask1, self.coarse_scale)
        return out
