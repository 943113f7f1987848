#!/usr/bin/env python3
"""Kernel C's bfloat16 fine stage at each count of window pairs a block.

    python3 tools/fine_group_sweep.py [--iters 20] [--out FILE]

The production launcher runs one pair a block (G = 1, two blocks an SM;
``csrc/fine_stage.cu`` ``launch_bf16``), the choice this table justifies.
This tool compiles ``csrc/fine_stage.cu`` once more, into
``build/fine_group_sweep/<hash>/``, inside a small source that adds one C
entry point taking G (1, 2 or 3), so the measurement needs no switch in the
production code.  For each G and each window-pair count -- the B=1 and B=8
forwards (1024, 8192), the B=2 hybrid training shape (1920) and 1021, which
no G > 1 divides -- it holds the output against ``fine_stage_plain`` at
chip_smoke.py's bf16 bar (5e-2 absolute plus 5e-2 relative) and times the
call: ``device_ms`` from the profiler, ``ms`` by CUDA events around
back-to-back calls.  It also prints each G's shared memory (G = 4 included:
it does not fit) and its registers and spills from the build's ``ptxas -v``
log.  One JSON object a line; exits 1 if a G disagrees, 2 without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (1, 2, 3)

SWEEP_CU = r"""
#include "fine_stage.cu"

// Kernel C in bfloat16 with the window pairs a block given by the caller.
extern "C" int loftr_fine_stage_pairs(const void* win0, const void* win1,
                                      const void* w0, const void* ln0,
                                      const void* w1, const void* ln1,
                                      void* out, int NB, float eps, int G,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (G) {
    case 1:
      loftr::launch_pairs<1>(win0, win1, w0, ln0, w1, ln1, out, NB, eps, st);
      break;
    case 2:
      loftr::launch_pairs<2>(win0, win1, w0, ln0, w1, ln1, out, NB, eps, st);
      break;
    case 3:
      loftr::launch_pairs<3>(win0, win1, w0, ln0, w1, ln1, out, NB, eps, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block of G pairs (bytes).
extern "C" long long loftr_fine_stage_smem(int G) {
  switch (G) {
    case 1: return loftr::Pairs<1>::kSmem;
    case 2: return loftr::Pairs<2>::kSmem;
    case 3: return loftr::Pairs<3>::kSmem;
    case 4: return loftr::Pairs<4>::kSmem;
    default: return -1;
  }
}
"""


def build():
    """Compile the sweep library; returns (ctypes library, ptxas log)."""
    from loftr_tpu_torch.ops.kernels import _build
    lib_path, log = _build.build_variant("fine_group_sweep", SWEEP_CU)
    lib = ctypes.CDLL(lib_path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.loftr_fine_stage_pairs.argtypes = [P] * 7 + [I, F, I, P]
    lib.loftr_fine_stage_pairs.restype = I
    lib.loftr_fine_stage_smem.argtypes = [I]
    lib.loftr_fine_stage_smem.restype = ctypes.c_longlong
    return lib, log


def registers(log):
    """{G: (registers, spill store bytes, spill load bytes)} of the bf16
    kernel's instantiations, from ``ptxas -v``."""
    regs, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"fine_stage_bf16ILi(\d+)E", m.group(1))
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
        print("fine_group_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms, device_ms, emit
    from loftr_tpu_torch.models.fused_fine import encoder_weights
    from loftr_tpu_torch.models.transformer import LoFTREncoderLayer
    from loftr_tpu_torch.ops.kernels import _build
    from loftr_tpu_torch.ops.kernels import fine_stage as KC
    from loftr_tpu_torch.utils.weights import init_weights

    log = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        log = open(args.out, "a")
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    lib, build_log = build()
    emit({"nvidia_smi": smi, "sms": props.multi_processor_count,
          "smem_bytes_by_pairs": {g: lib.loftr_fine_stage_smem(g)
                                  for g in (1, 2, 3, 4)},
          "smem_bytes_optin": getattr(props, "shared_memory_per_block_optin",
                                      None),
          "fine_stage_bf16_registers_spills":
              dict(sorted(registers(build_log).items()))},
         log)

    C, nh, bf16 = 128, 8, torch.bfloat16
    layers = [encoder_weights(init_weights(LoFTREncoderLayer(C, nh), s)
                              .to(dev)) for s in (2, 3)]
    (w0, ln0), (w1, ln1) = (KC.pack_weights(layer, bf16)
                            for layer in layers)
    rng = np.random.RandomState(0)
    ok_all = True
    p = ctypes.c_void_p
    for nb in (1024, 8192, 1920, 1021):
        a = torch.from_numpy(rng.randn(nb, 25, C) * 0.5).to(dev, bf16)
        b = torch.from_numpy(rng.randn(nb, 25, C) * 0.5).to(dev, bf16)
        want = KC.fine_stage_plain(a, b, layers[0], layers[1], nh)
        out = torch.empty((nb, 3), dtype=torch.float32, device=dev)
        for g in GROUPS:
            def run():
                err = lib.loftr_fine_stage_pairs(
                    p(a.data_ptr()), p(b.data_ptr()), p(w0.data_ptr()),
                    p(ln0.data_ptr()), p(w1.data_ptr()), p(ln1.data_ptr()),
                    p(out.data_ptr()), nb, 1e-6, g, p(_build.stream_ptr(a)))
                _build.check(err, "loftr_fine_stage_pairs")
            out.fill_(float("nan"))
            run()
            torch.cuda.synchronize()
            diff = (out - want).abs()
            ok = bool((diff <= 5e-2 + 5e-2 * want.abs()).all())
            ok_all = ok_all and ok
            emit({"NB": nb, "pairs_per_block": g, "blocks": -(-nb // g),
                  "max_abs_err": float(diff.max()),
                  "mean_abs_err": float(diff.mean()), "ok": ok,
                  "ms": cuda_ms(run, iters=args.iters),
                  "device_ms": (device_ms(run, iters=args.iters)
                                or {}).get("total")}, log)
    if log is not None:
        log.close()
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
