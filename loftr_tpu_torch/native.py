"""ctypes bindings to the in-tree C++ LO-RANSAC pose solver
(``native/src/ransac_essential.cc``; ``loftr_tpu.native``'s counterpart).

:func:`estimate_pose_native` is the in-tree replacement for OpenCV's
findEssentialMat/recoverPose (the reference's metrics.py:83-93): 8-point
hypotheses, Sampson scoring, Cauchy-IRLS local optimisation and
cheirality-voted pose recovery on the host.

The library builds on first use with ``g++`` (the flags of
``native/Makefile``) into ``build/loftr_tpu_torch_native/`` beside the
package, named by a hash of the source.  The build writes a temporary file
and renames it, so processes that build at once never load a half-written
library.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_REPO, "native", "src", "ransac_essential.cc")
BUILD_DIR = os.path.join(_REPO, "build", "loftr_tpu_torch_native")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native")

_lock = threading.Lock()
_lib = None


def _build() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"libloftr_native_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = os.path.join(BUILD_DIR, f".libloftr_native_{digest}.{os.getpid()}"
                       f".{threading.get_ident()}.so")
    out = subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared",
                          "-o", tmp, SOURCE], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed:\n{out.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded solver library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            fp = ctypes.POINTER(ctypes.c_float)
            dp = ctypes.POINTER(ctypes.c_double)
            lib.estimate_pose_essential.restype = ctypes.c_int
            lib.estimate_pose_essential.argtypes = [
                fp, fp, ctypes.c_int, dp, dp, ctypes.c_double, ctypes.c_int,
                ctypes.c_uint64, dp, dp, ctypes.POINTER(ctypes.c_ubyte)]
            _lib = lib
        return _lib


def estimate_pose_native(kpts0: np.ndarray, kpts1: np.ndarray,
                         K0: np.ndarray, K1: np.ndarray,
                         pixel_thr: float = 0.5,
                         num_hypotheses: int = 1024,
                         seed: int = 0
                         ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]:
    """LO-RANSAC essential pose.  Returns (R, t, inlier_mask) or None."""
    lib = library()
    n = len(kpts0)
    if n < 8:
        return None
    if np.shape(kpts0) != (n, 2) or np.shape(kpts1) != (n, 2):
        raise ValueError(f"kpts must both be [{n}, 2]: "
                         f"{np.shape(kpts0)}, {np.shape(kpts1)}")
    if np.shape(K0) != (3, 3) or np.shape(K1) != (3, 3):
        raise ValueError("K0 and K1 must be 3x3")
    p0 = np.ascontiguousarray(kpts0, np.float32)
    p1 = np.ascontiguousarray(kpts1, np.float32)
    K0d = np.ascontiguousarray(K0, np.float64)
    K1d = np.ascontiguousarray(K1, np.float64)
    R = np.zeros(9, np.float64)
    t = np.zeros(3, np.float64)
    mask = np.zeros(n, np.uint8)
    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    n_inl = lib.estimate_pose_essential(
        fptr(p0), fptr(p1), n, dptr(K0d), dptr(K1d),
        float(pixel_thr), int(num_hypotheses), int(seed),
        dptr(R), dptr(t),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if n_inl < 8:
        return None
    return R.reshape(3, 3), t, mask.astype(bool)
