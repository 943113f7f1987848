#!/usr/bin/env python3
"""Kernels F and G's bfloat16 paths at each ring depth and band height.

    python3 tools/window_upsample_sweep.py [--iters 20] [--out FILE]

The production launchers run kernel F (``csrc/window_attention.cu``,
``fine::launch``) with the ring depth ``fine::kStages`` a warp and the
register cap ``fine::kMinBlocks``, and kernel G (``csrc/upsample.cu``,
``band::launch``) with bands of ``band::kRows`` output rows, the choices
this table justifies.  The tool compiles both sources once more,
into ``build/window_attention_sweep/`` and ``build/upsample_sweep/``, each
inside a small source that adds a C entry point taking the ring's stages
and register cap (``STAGES``) or the band's rows (8 to 128), so the
measurement needs no switch in the production code.  At the main path's
shapes -- F at q = k = v [2048, 25, 128] and [1024, 25, 128] with 8 heads, G at [2,196,120,160] and [2,256,60,80] -- it
holds each variant's output against the plain version (F at chip_smoke.py's
bf16 bar against ``window_attention_plain`` on the card; G bit for bit
against ``upsample2x_plain`` on the CPU, whose float32 sums of exact
products are the function's) and times the call: ``device_ms`` from the
profiler, ``ms`` by CUDA events around back-to-back calls.  It prints each
variant's registers and spills from the build's ``ptxas -v`` log.  One
JSON object a line; exits 1 if a variant disagrees, 2 without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel F: (ring stages, blocks an SM the registers are capped for)
STAGES = ((2, 1), (2, 3), (2, 4), (3, 1), (3, 2), (4, 1))
ROWS = (8, 16, 32, 64, 128)

SWEEP_F = r"""
#include "window_attention.cu"

// Kernel F in bfloat16 at the fine shape with NST ring stages, registers
// capped for MINB blocks an SM.
extern "C" int loftr_window_attention_stages(const void* q, const void* k,
                                             const void* v, void* out, int NB,
                                             float eps, int NST, int MINB,
                                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CASE(S, M) \
  if (NST == S && MINB == M) \
    return loftr::fine::launch<S, M>(q, k, v, out, NB, eps, st);
  CASE(2, 1) CASE(2, 3) CASE(2, 4) CASE(3, 1) CASE(3, 2) CASE(4, 1)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
"""

SWEEP_G = r"""
#include "upsample.cu"

// Kernel G in bfloat16 with bands of ROWS output rows.
extern "C" int loftr_upsample2x_rows(const void* x, const void* ylo,
                                     const void* yhi, const void* alo,
                                     const void* ahi, const void* xlo,
                                     const void* xhi, const void* blo,
                                     const void* bhi, void* out, int BC,
                                     int H, int W, int ROWS, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err = (int)cudaErrorInvalidValue;
#define ARGS x, (const int*)ylo, (const int*)yhi, (const float*)alo, \
    (const float*)ahi, (const int*)xlo, (const int*)xhi, (const float*)blo, \
    (const float*)bhi, out, BC, H, W, st, &err
  switch (ROWS) {
    case 8: loftr::band::launch<8>(ARGS); break;
    case 16: loftr::band::launch<16>(ARGS); break;
    case 32: loftr::band::launch<32>(ARGS); break;
    case 64: loftr::band::launch<64>(ARGS); break;
    case 128: loftr::band::launch<128>(ARGS); break;
  }
#undef ARGS
  return err;
}
"""


def build():
    """Compile the two sweep libraries (one a source: both define the same
    helpers); returns (kernel F's, kernel G's, ptxas logs)."""
    from loftr_tpu_torch.ops.kernels import _build
    path_f, log_f = _build.build_variant("window_attention_sweep", SWEEP_F)
    path_g, log_g = _build.build_variant("upsample_sweep", SWEEP_G)
    lib_f, lib_g = ctypes.CDLL(path_f), ctypes.CDLL(path_g)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib_f.loftr_window_attention_stages.argtypes = [P] * 4 + [I, F, I, I, P]
    lib_g.loftr_upsample2x_rows.argtypes = [P] * 10 + [I] * 4 + [P]
    lib_f.loftr_window_attention_stages.restype = I
    lib_g.loftr_upsample2x_rows.restype = I
    return lib_f, lib_g, log_f + log_g


def registers(log):
    """{variant: (registers, spill store bytes, spill load bytes)} of the
    two bf16 kernels' instantiations, from ``ptxas -v``."""
    regs, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = (re.search(r"window_attn_bf16ILi(\d+)ELi(\d+)E", m.group(1))
                 or re.search(r"upsample2x_bandILb1ELi(\d+)E", m.group(1)))
            name = (None if k is None else
                    "stages %s, min blocks %s" % k.groups()
                    if "window" in k.group(0) else "rows " + k.group(1))
            spill = (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = (int(m.group(1)), *spill)
    return regs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("window_upsample_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms, device_ms, emit
    from loftr_tpu_torch.ops.kernels import _build
    from loftr_tpu_torch.ops.kernels import upsample as KG
    from loftr_tpu_torch.ops.kernels import window_attention as KF
    log = open(args.out, "a") if args.out else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    lib_f, lib_g, build_log = build()
    emit({"tool": "window_upsample_sweep", "nvidia_smi": smi,
          "registers": registers(build_log)}, log)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    p = ctypes.c_void_p
    bad = False

    for NB in (2048, 1024):
        q, k, v = (torch.from_numpy(rng.randn(NB, 25, 128).astype(
            np.float32)).to(dev, torch.bfloat16) for _ in range(3))
        want = KF.window_attention_plain(q, k, v, 8).float()
        for nst, minb in STAGES:
            out = torch.empty_like(q)

            def run(nst=nst, minb=minb, out=out):
                _build.check(lib_f.loftr_window_attention_stages(
                    p(q.data_ptr()), p(k.data_ptr()), p(v.data_ptr()),
                    p(out.data_ptr()), NB, 1e-6, nst, minb,
                    p(_build.stream_ptr(q))), "window attention sweep")
            run()
            torch.cuda.synchronize()
            d = (out.float() - want).abs()
            ok = bool((d <= 2e-3 + 2 ** -7 * want.abs()).all())
            bad |= not ok
            dms = device_ms(run) or {}
            emit({"kernel": "window_attention", "shape": [NB, 25, 128],
                  "stages": nst, "min_blocks": minb, "ok": ok,
                  "max_abs_err": float(d.max()),
                  "ms": cuda_ms(run, iters=args.iters),
                  "device_ms": dms.get("total")}, log)

    for shp in ((2, 196, 120, 160), (2, 256, 60, 80)):
        x = torch.from_numpy(rng.randn(*shp).astype(np.float32)).to(
            dev, torch.bfloat16)
        want = KG.upsample2x_plain(x.cpu())
        b, c, h, w = shp
        ty = KG._tap_tables(h, x.dtype, x.device)
        tx = KG._tap_tables(w, x.dtype, x.device)
        for rows in ROWS:
            out = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype,
                              device=dev)

            def run(rows=rows, out=out):
                _build.check(lib_g.loftr_upsample2x_rows(
                    p(x.data_ptr()), *[p(t.data_ptr()) for t in ty],
                    *[p(t.data_ptr()) for t in tx], p(out.data_ptr()),
                    b * c, h, w, rows, p(_build.stream_ptr(x))),
                    "upsample sweep")
            run()
            torch.cuda.synchronize()
            ok = torch.equal(out.cpu(), want)
            bad |= not ok
            dms = device_ms(run) or {}
            emit({"kernel": "upsample", "shape": list(shp), "rows": rows,
                  "ok": ok, "ms": cuda_ms(run, iters=args.iters),
                  "device_ms": dms.get("total")}, log)
    if log is not None:
        log.close()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
