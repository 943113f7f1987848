"""Photometric augmentations (numpy/cv2, host-side); a copy of
``loftr_tpu.data.augment``.

The reference declares DarkAug/MobileAug via albumentations but its
``build_augmentor`` raises for any method (src/utils/augment.py:41-43) and
the dataset call sites are commented out.  These are working equivalents of
the core photometric transforms on grayscale uint8 images, drawing from an
explicit numpy Generator in the same order as the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import cv2
import numpy as np


class DarkAug:
    """Extreme low-light augmentation (augment.py:4-19 semantics):
    brightness/contrast drop, blur, motion blur, gamma."""

    def __init__(self, p: float = 0.75):
        self.p = p

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        if rng.random() > self.p:
            return img
        out = img.astype(np.float32)
        if rng.random() < 0.75:  # brightness (-0.6, 0) / contrast (-0.5, .3)
            b = rng.uniform(-0.6, 0.0)
            c = 1.0 + rng.uniform(-0.5, 0.3)
            out = np.clip((out - 127.5) * c + 127.5 + b * 255, 0, 255)
        if rng.random() < 0.1:  # blur 3..9
            k = int(rng.integers(1, 5)) * 2 + 1
            out = cv2.blur(out, (k, k))
        if rng.random() < 0.2:  # motion blur 3..25
            k = int(rng.integers(1, 13)) * 2 + 1
            kern = np.zeros((k, k), np.float32)
            angle = rng.uniform(0, 180)
            c, s = np.cos(np.deg2rad(angle)), np.sin(np.deg2rad(angle))
            for i in range(k):
                x = int(round(k / 2 + (i - k / 2) * c))
                y = int(round(k / 2 + (i - k / 2) * s))
                if 0 <= x < k and 0 <= y < k:
                    kern[y, x] = 1.0
            kern /= max(kern.sum(), 1)
            out = cv2.filter2D(out, -1, kern)
        if rng.random() < 0.1:  # gamma 0.15..0.65 (albumentations /100)
            g = rng.uniform(0.15, 0.65)
            out = np.clip(((out / 255.0) ** g) * 255.0, 0, 255)
        return out.astype(img.dtype)


class MobileAug:
    """Handheld-device artifacts (augment.py:22-38 semantics): motion blur,
    jitter, JPEG recompression, sensor noise."""

    def __init__(self, p: float = 1.0):
        self.p = p

    def __call__(self, img: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        if rng.random() > self.p:
            return img
        out = img.astype(np.float32)
        if rng.random() < 0.25:  # motion blur
            k = int(rng.integers(1, 4)) * 2 + 1
            out = cv2.blur(out, (k, 1) if rng.random() < 0.5 else (1, k))
        if rng.random() < 0.5:  # brightness/contrast jitter
            b = rng.uniform(-0.2, 0.2)
            c = 1.0 + rng.uniform(-0.2, 0.2)
            out = np.clip((out - 127.5) * c + 127.5 + b * 255, 0, 255)
        if rng.random() < 0.25:  # JPEG recompression
            q = int(rng.integers(50, 95))
            ok, enc = cv2.imencode(".jpg", out.astype(np.uint8),
                                   [cv2.IMWRITE_JPEG_QUALITY, q])
            if ok:
                out = cv2.imdecode(enc, cv2.IMREAD_GRAYSCALE).astype(
                    np.float32)
        if rng.random() < 0.25:  # ISO-style noise
            sigma = rng.uniform(2, 8)
            out = np.clip(out + rng.normal(0, sigma, out.shape), 0, 255)
        return out.astype(img.dtype)


def build_augmentor(method: Optional[str] = None):
    """Dispatch (augment.py:41-51 signature, but the methods actually work)."""
    if method is None:
        return None
    if method == "dark":
        return DarkAug()
    if method == "mobile":
        return MobileAug()
    raise ValueError(f"Invalid augmentation method: {method}")
