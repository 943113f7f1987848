"""Float32 products in float32: a scoped guard against TF32 on the card
and reduced-precision float32 products on the CPU."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def true_float32(on: bool = True):
    """cuDNN's and cuBLAS's TF32 off while the block runs, when ``on``, and
    oneDNN's float32 products on the CPU in float32 (``torch.
    set_float32_matmul_precision("medium")`` makes them bf16); the previous
    settings are restored afterwards."""
    if not on:
        yield
        return
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = tuple(f.allow_tf32 for f in flags)
    cpu = getattr(torch.backends.mkldnn, "matmul", None)
    prev_cpu = getattr(cpu, "fp32_precision", None)
    for f in flags:
        f.allow_tf32 = False
    if prev_cpu is not None:
        cpu.fp32_precision = "ieee"
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.allow_tf32 = p
        if prev_cpu is not None:
            cpu.fp32_precision = prev_cpu
