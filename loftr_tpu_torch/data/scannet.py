"""ScanNet pair dataset (host-side numpy).

A copy of ``loftr_tpu.data.scannet`` (the reference's
src/datasets/scannet.py:17-114): one scene-set
per instance, pairs from a {scene}.npz 'name' array with overlap-score
filtering, 640x480 grayscale, depth/1000, per-scene intrinsics, relative
pose T_0to1 = pose1 @ inv(pose0) from world2cam txt files.

Additions: the eval fixture (assets/scannet_test_1500/test.npz) carries
'rel_pose' rows directly; when present and no pose dir is given, poses are
taken from the npz so the 1500-pair eval runs without the raw dataset's
pose files.
"""
from __future__ import annotations

import os.path as osp
from typing import Optional

import numpy as np

from loftr_tpu_torch.data.io import (read_scannet_depth, read_scannet_gray,
                                     read_scannet_pose)


class ScanNetDataset:
    def __init__(self, root_dir: str, npz_path: str, intrinsic_path: str,
                 mode: str = "train", min_overlap_score: float = 0.4,
                 pose_dir: Optional[str] = None, augment_fn=None):
        self.root_dir = root_dir
        self.pose_dir = pose_dir or root_dir
        self.mode = mode
        self.augment_fn = augment_fn if mode == "train" else None

        with np.load(npz_path) as data:
            self.data_names = data["name"]
            self.rel_poses = data["rel_pose"] if "rel_pose" in data else None
            if "score" in data and mode not in ("val", "test"):
                kept = data["score"] > min_overlap_score
                self.data_names = self.data_names[kept]
                if self.rel_poses is not None:
                    self.rel_poses = self.rel_poses[kept]
        self.intrinsics = dict(np.load(intrinsic_path))

    def __len__(self):
        return len(self.data_names)

    def _rel_pose(self, idx, scene_name, name0, name1) -> np.ndarray:
        if self.rel_poses is not None:
            T = np.eye(4)
            T[:3] = self.rel_poses[idx].reshape(3, 4)
            return T
        pose0 = read_scannet_pose(
            osp.join(self.pose_dir, scene_name, "pose", f"{name0}.txt"))
        pose1 = read_scannet_pose(
            osp.join(self.pose_dir, scene_name, "pose", f"{name1}.txt"))
        return pose1 @ np.linalg.inv(pose0)

    def __getitem__(self, idx):
        scene, sub, stem0, stem1 = self.data_names[idx]
        scene_name = f"scene{scene:04d}_{sub:02d}"
        img0 = read_scannet_gray(
            osp.join(self.root_dir, scene_name, "color", f"{stem0}.jpg"))
        img1 = read_scannet_gray(
            osp.join(self.root_dir, scene_name, "color", f"{stem1}.jpg"))
        if self.augment_fn is not None:
            rng = np.random.default_rng()
            for img in (img0, img1):
                u8 = (img[..., 0] * 255).astype(np.uint8)
                img[..., 0] = self.augment_fn(u8, rng).astype(
                    np.float32) / 255.0
        if self.mode in ("train", "val"):
            depth0 = read_scannet_depth(
                osp.join(self.root_dir, scene_name, "depth", f"{stem0}.png"))
            depth1 = read_scannet_depth(
                osp.join(self.root_dir, scene_name, "depth", f"{stem1}.png"))
        else:
            depth0 = depth1 = np.zeros((0,), np.float32)

        K = np.asarray(self.intrinsics[scene_name],
                       np.float32).reshape(3, 3).copy()
        T_0to1 = self._rel_pose(idx, scene_name, stem0, stem1).astype(
            np.float32)
        return {
            "image0": img0, "image1": img1,
            "depth0": depth0, "depth1": depth1,
            "T_0to1": T_0to1,
            "T_1to0": np.linalg.inv(T_0to1).astype(np.float32),
            "K0": K, "K1": K,
            "dataset_name": "ScanNet",
            "scene_id": scene_name,
            "pair_id": idx,
            "pair_names": (f"{scene_name}/color/{stem0}.jpg",
                           f"{scene_name}/color/{stem1}.jpg"),
        }
