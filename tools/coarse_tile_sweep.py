#!/usr/bin/env python3
"""Kernel A's bfloat16 apply pass at each row-tile height, on one CUDA card.

    python3 tools/coarse_tile_sweep.py [--iters 20] [--out FILE]

The production kernel picks its apply tile height itself (48 rows when that
grid fits one wave of the card's SMs, else 80; ``csrc/coarse_layer.cu``
``apply_rows``).  This tool compiles ``csrc/coarse_layer.cu`` once more,
into ``build/coarse_tile_sweep/<hash>/``, inside a small source that adds
one C entry point taking the height (32, 48, 64 or 80 rows), so the
measurement needs no switch in the production code.  For each height and
each shape -- the main path's self call x = src [2,4800,256], its cross call
[1,4800,256], and a masked ragged pair x [2,4700,256] / src [2,4750,256]
whose lengths are no multiple of any tile -- it holds the output against
``coarse_layer_plain`` at chip_smoke.py's bf16 bar (0.125 abs, mean 5e-3)
and times the call: ``device_ms`` from the profiler by kernel (the apply
pass under ``apply_bf16<TM>``), ``ms`` by CUDA events around back-to-back
calls.  It also prints each height's registers and spills from the build's
``ptxas -v`` log.  One JSON object a line; exits 1 if a height disagrees,
2 without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEIGHTS = (32, 48, 64, 80)

SWEEP_CU = r"""
#include "coarse_layer.cu"

// Kernel A in bfloat16 with the apply tile height given by the caller.
extern "C" int loftr_coarse_layer_rows(
    const void* x, const void* xmask, const void* src, const void* smask,
    const void* w, const void* ln, void* kv_part, void* ks_part, void* kv,
    void* ksum, void* out, int B, int L, int S, float eps, int rows,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  loftr::launch_kv_bf16(src, smask, w, kv_part, ks_part, kv, ksum, B, S, st);
  const float* kvf = (const float*)kv;
  const float* ksf = (const float*)ksum;
  switch (rows) {
    case 32:
      loftr::launch_apply<32>(x, xmask, kvf, ksf, w, ln, out, B, L, S, eps, st);
      break;
    case 48:
      loftr::launch_apply<48>(x, xmask, kvf, ksf, w, ln, out, B, L, S, eps, st);
      break;
    case 64:
      loftr::launch_apply<64>(x, xmask, kvf, ksf, w, ln, out, B, L, S, eps, st);
      break;
    case 80:
      loftr::launch_apply<80>(x, xmask, kvf, ksf, w, ln, out, B, L, S, eps, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""


def build():
    """Compile the sweep library; returns (ctypes library, ptxas log)."""
    from loftr_tpu_torch.ops.kernels import _build
    lib_path, log = _build.build_variant("coarse_tile_sweep", SWEEP_CU)
    lib = ctypes.CDLL(lib_path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.loftr_coarse_layer_rows.argtypes = [P] * 11 + [I] * 3 + [F, I, P]
    lib.loftr_coarse_layer_rows.restype = I
    return lib, log


def registers(log):
    """{height: (registers, spill store bytes, spill load bytes)} of the
    apply instantiations, from ``ptxas -v``."""
    regs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"apply_bf16ILi(\d+)E", m.group(1))
            name = int(k.group(1)) if k else None
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
        print("coarse_tile_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms, device_ms, emit
    from loftr_tpu_torch.models.fused_fine import encoder_weights
    from loftr_tpu_torch.models.transformer import LoFTREncoderLayer
    from loftr_tpu_torch.ops.kernels import _build
    from loftr_tpu_torch.ops.kernels import coarse_layer as KA
    from loftr_tpu_torch.ops.kernels.fine_stage import pack_weights
    from loftr_tpu_torch.utils.weights import init_weights

    log = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        log = open(args.out, "a")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    lib, build_log = build()
    emit({"nvidia_smi": smi, "sms": torch.cuda.get_device_properties(
        0).multi_processor_count, "apply_bf16_registers_spills":
        {str(k): v for k, v in sorted(registers(build_log).items())}}, log)

    C, nh, bf16 = 256, 8, torch.bfloat16
    w = encoder_weights(init_weights(LoFTREncoderLayer(C, nh), 1).to(dev))
    wbuf, ln = pack_weights(w, bf16)
    rng = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(a).to(dev)
    shapes = {
        "self_B2": (2, 4800, None, False),
        "cross_B1": (1, 4800, 4800, False),
        "ragged_B2_masked": (2, 4700, 4750, True),
    }
    ok_all = True
    for case, (B, L, S, masked) in shapes.items():
        x = t(rng.randn(B, L, C) * 0.5).to(bf16)
        src = x if S is None else t(rng.randn(B, S, C) * 0.5).to(bf16)
        S = src.shape[1]
        xm = t(rng.rand(B, L) > 0.2) if masked else None
        sm = t(rng.rand(B, S) > 0.2) if masked else None
        want = KA.coarse_layer_plain(x, src, w, xm, sm, nh).float()
        xmf = KA._mask_f32(xm, B, L, x)
        smf = KA._mask_f32(sm, B, S, x)
        d = C // nh
        ntiles = (S + KA.TILE_S - 1) // KA.TILE_S
        sizes = (B * ntiles * C * d, B * ntiles * C, B * C * d, B * C)
        scratch = torch.empty(sum(sizes), dtype=torch.float32,
                              device=dev).split(sizes)
        out = torch.empty_like(x)
        p = ctypes.c_void_p
        for tm in HEIGHTS:
            def run():
                err = lib.loftr_coarse_layer_rows(
                    p(x.data_ptr()), p(xmf.data_ptr()), p(src.data_ptr()),
                    p(smf.data_ptr()), p(wbuf.data_ptr()), p(ln.data_ptr()),
                    *(p(s.data_ptr()) for s in scratch), p(out.data_ptr()),
                    B, L, S, 1e-6, tm, p(_build.stream_ptr(x)))
                _build.check(err, "loftr_coarse_layer_rows")
            out.zero_()
            run()
            torch.cuda.synchronize()
            diff = (out.float() - want).abs()
            ok = float(diff.max()) <= 0.125 and float(diff.mean()) <= 5e-3
            ok_all = ok_all and ok
            dev_ms = device_ms(run, iters=args.iters) or {}
            emit({"case": case, "x": [B, L, C], "src": [B, S, C],
                  "rows": tm, "blocks": B * -(-L // tm),
                  "max_abs_err": float(diff.max()),
                  "mean_abs_err": float(diff.mean()), "ok": ok,
                  "ms": cuda_ms(run, iters=args.iters),
                  "device_ms": dev_ms.get("total"),
                  "apply_device_ms": dev_ms.get(f"apply_bf16<{tm}>")}, log)
    if log is not None:
        log.close()
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
