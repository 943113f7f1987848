"""Synthetic multi-view benchmark scenes (exact GT depth/pose/intrinsics);
a copy of ``loftr_tpu.data.synthetic``.

Renders geometrically-consistent image pairs from a textured random
heightfield and writes them in the MegaDepth on-disk layout (scene-info npz
+ image files + depth files, the contract of data/megadepth.py and the
reference's src/datasets/megadepth.py:11-127), so the evaluation and
training stacks (MegaDepthDataset -> DataLoader -> Evaluator -> pose
solvers -> aggregate_metrics) run on it with nothing downloaded.  Depth is
written as ``.h5`` (dataset ``depth``, as MegaDepth ships it), or as
``.npy`` when the caller asks for ``depth_format="npy"`` (a host without
``h5py``); ``data/io.py`` reads both.

Rendering model: a Lambertian heightfield  z = h(x, y)  over the world
ground plane, textured by a multi-octave value-noise albedo.  For camera i
with intrinsics K and cam2world (R, C), every pixel ray
p(t) = C + t * R * K^-1 [u, v, 1] is intersected with the surface by
fixed-point iteration on  t = (h(x(t), y(t)) - C_z) / d_z  (converges for
gentle slopes); `depth = t` is then exactly the camera z-depth the
supervision/warp math expects (supervision.py::warp_kpts), because the
third component of K^-1 [u, v, 1] is 1.  The heightfield makes the scene
non-planar, keeping essential-matrix estimation well-conditioned (a plane
would be a degenerate configuration for the 5/8-point solvers).
"""
from __future__ import annotations

import os
import os.path as osp
from typing import List, Optional, Sequence, Tuple

import numpy as np


# ------------------------------------------------------------------ fields
def value_noise(rng: np.random.RandomState, n: int, octaves: int = 5,
                base_res: int = 4, persistence: float = 0.55) -> np.ndarray:
    """Multi-octave smooth value noise in [0, 1], shape [n, n]."""
    import cv2

    acc = np.zeros((n, n), np.float64)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        res = base_res * (2 ** o)
        if res >= n:
            break
        g = rng.rand(res, res)
        up = cv2.resize(g, (n, n), interpolation=cv2.INTER_CUBIC)
        acc += amp * up
        total += amp
        amp *= persistence
    acc /= max(total, 1e-9)
    lo, hi = acc.min(), acc.max()
    return ((acc - lo) / (hi - lo + 1e-9)).astype(np.float32)


def _bilinear_wrap(field: np.ndarray, px: np.ndarray, py: np.ndarray
                   ) -> np.ndarray:
    """Bilinear sample `field` [n, n] at continuous (px, py) with wrap
    addressing — one consistent world-to-value function for all views."""
    n = field.shape[0]
    px = np.mod(px, n)
    py = np.mod(py, n)
    x0 = np.floor(px).astype(np.int64)
    y0 = np.floor(py).astype(np.int64)
    fx = (px - x0).astype(np.float32)
    fy = (py - y0).astype(np.float32)
    x1 = (x0 + 1) % n
    y1 = (y0 + 1) % n
    f00 = field[y0, x0]
    f01 = field[y0, x1]
    f10 = field[y1, x0]
    f11 = field[y1, x1]
    return (f00 * (1 - fx) * (1 - fy) + f01 * fx * (1 - fy)
            + f10 * (1 - fx) * fy + f11 * fx * fy)


class HeightfieldScene:
    """World: albedo texture + heightfield over (x, y), both wrap-tiled
    with `extent` world units per tile."""

    def __init__(self, seed: int, tex_res: int = 1024, field_res: int = 256,
                 extent: float = 8.0, z0: float = 3.0, z_amp: float = 0.45):
        rng = np.random.RandomState(seed)
        self.texture = value_noise(rng, tex_res, octaves=7, base_res=8)
        self.height = z0 + z_amp * (
            2.0 * value_noise(rng, field_res, octaves=4, base_res=3) - 1.0)
        self.extent = float(extent)
        self.z0 = float(z0)

    def _world_to_px(self, x: np.ndarray, y: np.ndarray, res: int):
        s = res / self.extent
        return x * s, y * s

    def sample_height(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        px, py = self._world_to_px(x, y, self.height.shape[0])
        return _bilinear_wrap(self.height, px, py)

    def sample_albedo(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        px, py = self._world_to_px(x, y, self.texture.shape[0])
        return _bilinear_wrap(self.texture, px, py)

    def render(self, K: np.ndarray, cam2world: np.ndarray,
               H: int, W: int, iters: int = 20
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Ray-cast one view.  Returns (image [H, W] float32 in [0, 1],
        depth [H, W] float32 camera z-depth)."""
        R = cam2world[:3, :3]
        C = cam2world[:3, 3]
        u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                           np.arange(H, dtype=np.float64))
        Kinv = np.linalg.inv(K.astype(np.float64))
        d_cam = np.stack([u, v, np.ones_like(u)], -1) @ Kinv.T  # z-comp == 1
        d = d_cam @ R.T                                         # world dirs
        dz = d[..., 2]
        assert float(np.min(np.abs(dz))) > 0.2, \
            "camera must face the surface (|d_z| bounded away from 0)"
        t = (self.z0 - C[2]) / dz
        for _ in range(iters):
            x = C[0] + t * d[..., 0]
            y = C[1] + t * d[..., 1]
            t = (self.sample_height(x, y) - C[2]) / dz
        x = C[0] + t * d[..., 0]
        y = C[1] + t * d[..., 1]
        img = self.sample_albedo(x, y)
        return img.astype(np.float32), t.astype(np.float32)


# ------------------------------------------------------------------ poses
def _rot(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    Kx = np.array([[0, -axis[2], axis[1]],
                   [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * Kx
            + (1 - np.cos(angle)) * Kx @ Kx)


def make_trajectory(rng: np.random.RandomState, n_views: int,
                    baseline: float = 0.35, rot_deg: float = 6.0
                    ) -> List[np.ndarray]:
    """cam2world poses: cameras near the origin looking +z, with random
    lateral offsets (~`baseline` world units between consecutive views —
    ~12% of the mean 3.0 depth, a healthy stereo baseline) and small
    rotations."""
    poses = []
    c = np.zeros(3)
    for i in range(n_views):
        if i:
            step = rng.randn(3) * [1.0, 0.6, 0.25]
            # fixed magnitude in [0.75b, 1.25b]: a randn-magnitude step can
            # land near zero, making the translation-direction metric
            # (relative_pose_error) pure noise for that pair
            step *= (baseline * (0.75 + 0.5 * rng.rand())
                     / (np.linalg.norm(step) + 1e-9))
            c = c + step
        aa = rng.randn(3) * np.deg2rad(rot_deg) / np.sqrt(3)
        R = _rot(aa, float(np.linalg.norm(aa) + 1e-12))
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = c
        poses.append(T)
    return poses


# ------------------------------------------------------- megadepth writer
def _write_depth(out_dir: str, stem: str, depth: np.ndarray,
                 depth_format: str) -> str:
    """Write ``{stem}.h5`` or ``{stem}.npy`` as ``depth_format`` says;
    returns the path relative to ``out_dir``."""
    if depth_format == "npy":
        np.save(osp.join(out_dir, stem + ".npy"), depth)
        return stem + ".npy"
    if depth_format != "h5":
        raise ValueError(f"depth_format must be 'h5' or 'npy', got "
                         f"{depth_format!r}")
    import h5py
    with h5py.File(osp.join(out_dir, stem + ".h5"), "w") as hf:
        hf.create_dataset("depth", data=depth)
    return stem + ".h5"


def write_megadepth_scene(out_dir: str, scene_name: str, seed: int,
                          n_views: int = 8, img_size: int = 256,
                          pair_stride: int = 2,
                          overlap_score: float = 0.7,
                          baseline: float = 0.35,
                          rot_deg: float = 6.0,
                          depth_format: str = "h5") -> str:
    """Render one scene and write it in the MegaDepth layout:

      {out_dir}/index/{scene_name}.npz           scene-info npz
      {out_dir}/images/{scene_name}/v{i}.png     uint8 grayscale
      {out_dir}/depths/{scene_name}/v{i}.h5      float32 'depth' dataset

    ({out_dir}/depths/{scene_name}/v{i}.npy with ``depth_format="npy"``.)
    Pairs: all (i, j) with 0 < j - i <= pair_stride.  Returns the npz path.
    """
    import cv2

    rng = np.random.RandomState(seed)
    scene = HeightfieldScene(seed=seed + 10_000)
    H = W = int(img_size)
    f = 1.1 * W
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], np.float64)
    cam2worlds = make_trajectory(rng, n_views, baseline=baseline,
                                 rot_deg=rot_deg)

    img_dir = osp.join(out_dir, "images", scene_name)
    dep_dir = osp.join(out_dir, "depths", scene_name)
    idx_dir = osp.join(out_dir, "index")
    for d in (img_dir, dep_dir, idx_dir):
        os.makedirs(d, exist_ok=True)

    image_paths, depth_paths, intrinsics, poses = [], [], [], []
    for i, c2w in enumerate(cam2worlds):
        img, depth = scene.render(K, c2w, H, W)
        ip = osp.join("images", scene_name, f"v{i}.png")
        cv2.imwrite(osp.join(out_dir, ip),
                    np.round(img * 255).astype(np.uint8))
        dp = _write_depth(out_dir, osp.join("depths", scene_name, f"v{i}"),
                          depth, depth_format)
        image_paths.append(ip)
        depth_paths.append(dp)
        intrinsics.append(K.astype(np.float32))
        poses.append(np.linalg.inv(c2w))  # megadepth stores world2cam

    pair_infos = []
    for i in range(n_views):
        for j in range(i + 1, min(i + 1 + pair_stride, n_views)):
            pair_infos.append(((i, j), overlap_score, None))

    npz_path = osp.join(idx_dir, f"{scene_name}.npz")
    np.savez(
        npz_path,
        image_paths=np.asarray(image_paths, object),
        depth_paths=np.asarray(depth_paths, object),
        intrinsics=np.asarray(intrinsics),
        poses=np.asarray(poses),
        pair_infos=np.asarray(pair_infos, object),
    )
    return npz_path


def make_synthetic_megadepth(out_dir: str, n_scenes: int = 3,
                             n_views: int = 8, img_size: int = 256,
                             seed: int = 0, baseline: float = 0.35,
                             scene_prefix: str = "synth",
                             depth_format: str = "h5") -> List[str]:
    """Write `n_scenes` scenes; returns the scene npz paths.  A scene-list
    txt (for train.py --list-path style flows) is written alongside.
    ``depth_format``: "h5" or "npy" (see ``_write_depth``)."""
    paths = []
    names = []
    for s in range(n_scenes):
        name = f"{scene_prefix}_{s:04d}"
        paths.append(write_megadepth_scene(
            out_dir, name, seed=seed + 97 * s, n_views=n_views,
            img_size=img_size, baseline=baseline,
            depth_format=depth_format))
        names.append(name)
    with open(osp.join(out_dir, "index", "scene_list.txt"), "w") as fh:
        fh.write("\n".join(names) + "\n")
    return paths


# ---------------------------------------------------------- scannet writer
def write_scannet_sequence(out_dir: str, n_frames: int = 60,
                           size: Tuple[int, int] = (640, 480),
                           seed: int = 0) -> np.ndarray:
    """Render a hand-held sweep over the heightfield and write it in the
    ScanNet layout:

      {out_dir}/color/{i}.jpg                     BGR JPEG (tinted gray)
      {out_dir}/depth/{i}.png                     uint16 depth in mm
      {out_dir}/pose/{i}.txt                      4x4 cam2world
      {out_dir}/intrinsic/intrinsic_color.txt     4x4, K top-left

    The cameras look +z from near z = 0 and move 0.04 world units a frame
    along x with a slow sideways wobble, a slow yaw and a little tilt.
    size is (W, H); the focal length is ScanNet's 577.87 px at 640x480,
    scaled with W.  One thread a CPU core renders the frames.  Returns K."""
    import cv2
    from concurrent.futures import ThreadPoolExecutor

    W, H = size
    f = 577.87 * W / 640.0
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1]], np.float64)
    scene = HeightfieldScene(seed=seed + 10_000)
    for d in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(osp.join(out_dir, d), exist_ok=True)
    K4 = np.eye(4)
    K4[:3, :3] = K
    np.savetxt(osp.join(out_dir, "intrinsic", "intrinsic_color.txt"), K4,
               delimiter=" ")
    tint = np.array([0.9, 1.0, 1.1])

    def write(i):
        c2w = np.eye(4)
        c2w[:3, :3] = (_rot(np.array([0.0, 0.0, 1.0]), np.deg2rad(0.15) * i)
                       @ _rot(np.array([1.0, 0.0, 0.0]),
                              0.05 * np.sin(i / 11.0)))
        c2w[:3, 3] = [0.04 * i, 0.3 * np.sin(i / 15.0),
                      0.05 * np.sin(i / 9.0)]
        img, depth = scene.render(K, c2w, H, W)
        bgr = np.clip(img[..., None] * tint * 255, 0, 255).astype(np.uint8)
        cv2.imwrite(osp.join(out_dir, "color", f"{i}.jpg"), bgr)
        cv2.imwrite(osp.join(out_dir, "depth", f"{i}.png"),
                    np.round(depth * 1000).astype(np.uint16))
        np.savetxt(osp.join(out_dir, "pose", f"{i}.txt"), c2w, delimiter=" ")

    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        list(ex.map(write, range(n_frames)))
    return K
