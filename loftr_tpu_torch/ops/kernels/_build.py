"""Build and load the port's CUDA kernels (``loftr_tpu_torch/csrc/*.cu``).

The sources have a plain C interface (no PyTorch headers), so each builds
with ``nvcc`` in seconds.  At first use every ``.cu`` file compiles to an
object in its own ``nvcc`` process, all started together, and the objects
link into one shared library under ``build/loftr_tpu_torch/<hash>/`` at the
repository root, keyed by a hash of the sources and flags.  The library is
loaded with ``ctypes``; pointers and the stream are passed as
``ctypes.c_void_p``.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent code only runs when a CUDA tensor reaches a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "loftr_tpu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# C entry points: name -> argument types (each returns cudaGetLastError()).
SIGNATURES = {
    "loftr_coarse_layer": [_P] * 11 + [_I] * 5 + [_F, _I, _P],
    "loftr_dual_softmax": [_P] * 15 + [_I] * 5 + [_F, _I, _P],
    "loftr_fine_stage": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
    "loftr_dual_softmax_stats": [_P] * 12 + [_I] * 5 + [_F, _I, _P],
    "loftr_dual_softmax_bf16": [_P] * 13 + [_I] * 7 + [_F, _P],
    "loftr_dual_softmax_bf16_stats": [_P] * 10 + [_I] * 7 + [_F, _P],
    "loftr_focal_fwd": [_P] * 13 + [_I] * 5 + [_F] * 3 + [_I, _P],
    "loftr_focal_bwd": [_P] * 18 + [_I] * 5 + [_F] * 4 + [_I, _P],
    "loftr_focal_prescale": [_P] * 4 + [_LL] * 2 + [_F, _P],
    "loftr_focal_bf16_fwd": [_P] * 15 + [_I] * 4 + [_F] * 2 + [_I, _P],
    "loftr_focal_bf16_bwd": [_P] * 16 + [_I] * 5 + [_F] * 3 + [_P],
    "loftr_sinkhorn": [_P] * 21 + [_I] * 7 + [_F, _I, _P],
    "loftr_sinkhorn_bf16": [_P] * 22 + [_I] * 8 + [_F, _P],
    "loftr_window_attention": [_P] * 4 + [_I] * 4 + [_F, _I, _P],
    "loftr_upsample2x": [_P] * 10 + [_I] * 4 + [_P],
    "loftr_upsample2x_add": [_P] * 11 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process, if it built
build_dir = None      # directory of the loaded library and its build.log


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources():
    names = sorted(os.listdir(CSRC))
    cu = [os.path.join(CSRC, n) for n in names if n.endswith(".cu")]
    deps = [os.path.join(CSRC, n) for n in names
            if n.endswith((".cu", ".cuh"))]
    return cu, deps


def _build(out_dir: str, cu_files) -> str:
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    objs = []
    for src in cu_files:
        obj = os.path.join(out_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v", "-c", src,
               "-o", obj]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
        objs.append(obj)
    logs = []
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write("\n".join(logs))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs))
    tmp = os.path.join(out_dir, f"libloftr_kernels.{os.getpid()}.so")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", tmp],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    lib_path = os.path.join(out_dir, "libloftr_kernels.so")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources at first use."""
    global _lib, build_seconds, build_dir
    with _lock:
        if _lib is not None:
            return _lib
        cu_files, deps = _sources()
        h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
        for path in deps:
            h.update(os.path.basename(path).encode())
            with open(path, "rb") as f:
                h.update(f.read())
        out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
        lib_path = os.path.join(out_dir, "libloftr_kernels.so")
        if not os.path.exists(lib_path):
            t0 = time.perf_counter()
            lib_path = _build(out_dir, cu_files)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(lib_path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib, build_dir = lib, out_dir
        return lib


def build_variant(name: str, source: str):
    """Compile ``source`` (C++ that may ``#include`` the sources of
    ``csrc/``) into a library of its own under ``build/<name>/<hash>/``,
    with ``ptxas -v``; the measurement tools use it to add entry points
    without touching the production library.  Returns (library path, build
    log)."""
    h = hashlib.sha256(source.encode())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for path in _sources()[1]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    out_dir = os.path.join(os.path.dirname(BUILD_ROOT), name,
                           h.hexdigest()[:16])
    lib_path = os.path.join(out_dir, f"lib{name}.so")
    log_path = os.path.join(out_dir, "build.log")
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        src = os.path.join(out_dir, name + ".cu")
        with open(src, "w") as f:
            f.write(source)
        r = subprocess.run(
            [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-I", CSRC, src, "-o", lib_path], capture_output=True, text=True)
        with open(log_path, "w") as f:
            f.write(r.stdout + r.stderr)
        if r.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + r.stdout + r.stderr)
    with open(log_path) as f:
        return lib_path, f.read()


def runs_plain(name: str, *tensors) -> bool:
    """The device rule of every wrapper: True when all ``tensors`` lie on
    the CPU (the wrapper then runs its plain version), False when all lie
    on one CUDA device (it launches its kernel); ``ValueError`` for
    anything else, such as a meta tensor or a CUDA tensor beside a CPU
    one.  ``None`` (an optional input left out) is skipped."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"{name} takes CPU or CUDA tensors on one device, got "
                     + ", ".join(sorted(str(d) for d in devices)))


def check(err: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t) -> int:
    """0 = float32, 1 = bfloat16 (the two types every kernel takes)."""
    import torch
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
