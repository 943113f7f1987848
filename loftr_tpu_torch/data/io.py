"""Host-side image/depth IO (numpy; cv2/h5py native decoders); a copy of
``loftr_tpu.data.io``.

The reference's src/utils/dataset.py:39-185 without torch: grayscale
decode, longer-edge resize, divisibility crop, bottom-right zero-padding
with validity masks, ScanNet depth PNG (/1000) and pose txt (world2cam =
inv(cam2world)), MegaDepth depth.

MegaDepth depth is an ``.h5`` file (dataset ``depth``); a ``.npy`` file of
the same array is read too, which is what ``data/synthetic.py`` writes when
asked for ``depth_format="npy"``.  ``cv2`` and ``h5py`` are imported where they are
used, so a host without ``h5py`` reads images and ``.npy`` depth.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def imread_gray(path: str) -> np.ndarray:
    import cv2
    image = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if image is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return image  # (h, w) uint8


def get_resized_wh(w: int, h: int, resize: Optional[int]) -> Tuple[int, int]:
    """Resize the longer edge to `resize` (dataset.py:55-61)."""
    if resize is None:
        return w, h
    scale = resize / max(h, w)
    return int(round(w * scale)), int(round(h * scale))


def get_divisible_wh(w: int, h: int, df: Optional[int]) -> Tuple[int, int]:
    """Floor to a multiple of df (dataset.py:64-69)."""
    if df is None:
        return w, h
    return int(w // df * df), int(h // df * df)


def pad_bottom_right(inp: np.ndarray, pad_size: int, ret_mask: bool = False):
    """Zero-pad a (h, w) array to (pad_size, pad_size) (dataset.py:72-89)."""
    if pad_size < max(inp.shape[-2:]):
        raise ValueError(f"pad size {pad_size} < {max(inp.shape[-2:])}")
    padded = np.zeros((pad_size, pad_size), dtype=inp.dtype)
    padded[: inp.shape[0], : inp.shape[1]] = inp
    mask = None
    if ret_mask:
        mask = np.zeros((pad_size, pad_size), dtype=bool)
        mask[: inp.shape[0], : inp.shape[1]] = True
    return padded, mask


def read_megadepth_gray(path: str, resize: Optional[int] = None,
                        df: Optional[int] = None, padding: bool = False):
    """(image [h,w,1] float32 in [0,1], mask [h,w] bool | None,
    scale [2] float32 = [w/w_new, h/h_new]) (dataset.py:94-125)."""
    import cv2
    image = imread_gray(path)
    h, w = image.shape
    w_new, h_new = get_resized_wh(w, h, resize)
    w_new, h_new = get_divisible_wh(w_new, h_new, df)
    image = cv2.resize(image, (w_new, h_new))
    scale = np.array([w / w_new, h / h_new], np.float32)
    mask = None
    if padding:
        pad_to = max(h_new, w_new)
        image, mask = pad_bottom_right(image, pad_to, ret_mask=True)
    image = image.astype(np.float32)[..., None] / 255.0
    return image, mask, scale


def read_megadepth_depth(path: str, pad_to: Optional[int] = None
                         ) -> np.ndarray:
    if str(path).endswith(".npy"):
        depth = np.load(path)
    else:
        import h5py
        with h5py.File(path, "r") as f:
            depth = np.array(f["depth"])
    if pad_to is not None:
        depth, _ = pad_bottom_right(depth, pad_to, ret_mask=False)
    return depth.astype(np.float32)


def read_scannet_gray(path: str, resize: Tuple[int, int] = (640, 480)
                      ) -> np.ndarray:
    """[h, w, 1] float32 in [0,1]; resize is (w, h) to align with depth
    (dataset.py:141-157)."""
    import cv2
    image = imread_gray(path)
    image = cv2.resize(image, resize)
    return image.astype(np.float32)[..., None] / 255.0


def read_scannet_depth(path: str) -> np.ndarray:
    import cv2
    depth = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if depth is None:
        raise FileNotFoundError(f"cannot read depth {path}")
    return (depth / 1000.0).astype(np.float32)


def read_scannet_pose(path: str) -> np.ndarray:
    """world2cam = inv(cam2world txt) (dataset.py:170-178)."""
    cam2world = np.loadtxt(path, delimiter=" ")
    return np.linalg.inv(cam2world)


def read_scannet_intrinsic(path: str) -> np.ndarray:
    intrinsic = np.loadtxt(path, delimiter=" ")
    return intrinsic[:-1, :-1]
