#!/usr/bin/env python3
"""Kernel E's bfloat16 path at each tile shape and chunk count, on one CUDA
card.

    python3 tools/sinkhorn_chunk_sweep.py [--iters 20] [--out FILE]

The production launcher takes one tile shape (R = 128 resident rows, N =
128 streamed rows a ring stage, 2 stages) and the streamed tiles a block of
each orientation from ``sinkhorn_plan`` in ``ops/kernels/sinkhorn.py``.
This tool compiles ``csrc/sinkhorn.cu`` once more, into
``build/sinkhorn_chunk_sweep/<hash>/``, inside a small source that adds one
C entry point taking the warp layout, ring depth and both orientations'
chunk sizes, so the measurement needs no switch in the production code.
For each shape (the two best of kernel B's sweep, 128 x 128 and 64 x 64 with
2 stages, and 128 x 64) and each of a few chunk counts (the same count in
both orientations, as L = S), at the OT main path's launches [1,4800,256]
and [8,4800,256] (unmasked, 3 iterations, ``bin_score`` 1.5, 1500 planted
pairs), it holds the outputs against ``sinkhorn_plain`` (1e-6 + 1e-4 |ref|
on best_val and colconf, best_j and the flags equal outside near-ties, as
chip_smoke.py phase 2) and times the call: ``device_ms`` from the profiler
(every pass and combine), ``pass_ms`` the three pass kernels by name,
``ms`` by CUDA events around back-to-back calls.  It also prints each
instantiation's registers and spills from the build's ``ptxas -v`` log and
the chunk count ``sinkhorn_plan`` picks.  One JSON object a line; exits 1 if
a case disagrees, 2 without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (warps down the rows WR, n8 tiles a warp NJ, ring stages NST): R = 32 WR,
# N = 64 NJ / WR
CONFIGS = ((4, 8, 2), (2, 2, 2), (4, 4, 2))
CHUNKS = (1, 2, 3, 4, 6, 10, 19, 38)   # chunks a row tile (nch) to try

SWEEP_CU = r"""
#include "sinkhorn.cu"

// Kernel E's bfloat16 path with the tile shape given by the caller.
extern "C" int loftr_sinkhorn_bf16_cfg(
    const void* f0, const void* f1, const void* m0, const void* m1,
    const void* alpha, void* u, void* v, void* ubin, void* vbin, void* pa,
    void* pb, void* pc, void* qa, void* qb, void* cpa, void* keep0,
    void* keep1, void* best_val, void* best_j, void* colconf, void* pf0,
    void* pf1, int B, int L, int S, int wr, int nj, int nst, int ct_row,
    int ct_col, int iters, int prefilter, float scale, void* stream) {
  using loftr::ring::bf16;
  cudaStream_t st = (cudaStream_t)stream;
#define CASE(A, J, N)                                                      \
  if (wr == A && nj == J && nst == N)                                      \
    return loftr::bf::launch<A, J, N>(                                     \
        (const bf16*)f0, (const bf16*)f1, (const float*)m0,                \
        (const float*)m1, (const float*)alpha, (float*)u, (float*)v,       \
        (float*)ubin, (float*)vbin, (float*)pa, (float*)pb, (float*)pc,    \
        (float*)qa, (float*)qb, (float*)cpa, (float*)keep0,                \
        (float*)keep1, (float*)best_val, (int*)best_j, (float*)colconf,    \
        (unsigned char*)pf0, (unsigned char*)pf1, B, L, S, ct_row, ct_col, \
        iters, prefilter, scale, st);
  CASE(4, 8, 2)
  CASE(2, 2, 2)
  CASE(4, 4, 2)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
"""


def shape_of(cfg):
    wr, nj, nst = cfg
    return 32 * wr, 64 * nj // wr, nst


def build():
    """Compile the sweep library; returns (ctypes library, ptxas log)."""
    from loftr_tpu_torch.ops.kernels import _build
    lib_path, log = _build.build_variant("sinkhorn_chunk_sweep", SWEEP_CU)
    lib = ctypes.CDLL(lib_path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.loftr_sinkhorn_bf16_cfg.argtypes = [P] * 22 + [I] * 10 + [F, P]
    lib.loftr_sinkhorn_bf16_cfg.restype = I
    return lib, log


def registers(log):
    """{"WR,NJ,NST,MODE": (registers, spill store bytes, spill load bytes)}
    of the bf16 pass kernels, from ``ptxas -v``."""
    regs, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"sinkhorn_bf16ILi(\d)ELi(\d)ELi(\d)ELi(\d)E",
                          m.group(1))
            name = ",".join(k.groups()) if k else None
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
        print("sinkhorn_chunk_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, REPO)
    from chip_smoke import (cuda_ms, device_ms, emit, ot_case,
                            rel_gap_top2)
    from loftr_tpu_torch.ops.kernels import sinkhorn as KE

    log = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        log = open(args.out, "a")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib, build_log = build()
    emit({"nvidia_smi": smi, "sms": sms,
          "registers_spills": registers(build_log)}, log)

    C, L, iters = 256, 4800, 3
    rng = np.random.RandomState(0)
    alpha = torch.tensor(1.5, device=dev)
    p = ctypes.c_void_p
    ok_all = True
    for B in (1, 8):
        f0, f1 = ot_case(rng, B, L, C, 1500)
        a = torch.from_numpy(f0).to(dev, torch.bfloat16)
        b = torch.from_numpy(f1).to(dev, torch.bfloat16)
        pv, pj, pc, p0, p1, conf, mar0, mar1 = KE.sinkhorn_plain(
            a, b, alpha, iters, with_conf=True)
        tie0, tie1 = mar0.abs() < 1e-5, mar1.abs() < 1e-5
        near = rel_gap_top2(conf) < 1e-5
        del conf
        for cfg in CONFIGS:
            R, N, nst = shape_of(cfg)
            nrt, nct = math.ceil(L / R), math.ceil(L / N)
            plan_ct = KE.bf16_plan(B, L, L, sms, R, N)[2]
            cts = sorted({math.ceil(nct / n) for n in CHUNKS if n <= nct}
                         | {plan_ct}, reverse=True)
            for ct in cts:
                nch = math.ceil(nct / ct)
                sizes = (B * L, B * L, B, B, *(B * nch * L,) * 5,
                         B * nrt * L, B * L, B * L)
                buf = torch.empty(sum(sizes), dtype=torch.float32,
                                  device=dev)
                kv = torch.empty((B, L), dtype=torch.float32, device=dev)
                kj = torch.empty((B, L), dtype=torch.int32, device=dev)
                kc = torch.empty((B, L), dtype=torch.float32, device=dev)
                k0 = torch.empty((B, L), dtype=torch.bool, device=dev)
                k1 = torch.empty((B, L), dtype=torch.bool, device=dev)
                ptrs = [p(a.data_ptr()), p(b.data_ptr()), p(None), p(None),
                        p(alpha.float().reshape(1).data_ptr())] + [
                    p(t.data_ptr()) for t in (*buf.split(sizes), kv, kj, kc,
                                              k0, k1)]

                def run():
                    buf[:2 * B * (L + 1)].zero_()
                    err = lib.loftr_sinkhorn_bf16_cfg(
                        *ptrs, B, L, L, *cfg, ct, ct, iters, 0, 1.0 / C,
                        p(torch.cuda.current_stream().cuda_stream))
                    if err:
                        raise RuntimeError(f"launch error {err}")
                run()
                torch.cuda.synchronize()
                okv = bool(((kv - pv).abs() <= 1e-6 + 1e-4 * pv.abs()).all())
                okc = bool(((kc - pc).abs() <= 1e-6 + 1e-4 * pc.abs()).all())
                unexplained = int(((kj != pj) & ~near).sum()
                                  + ((k0 != p0) & ~tie0).sum()
                                  + ((k1 != p1) & ~tie1).sum())
                ok = okv and okc and unexplained == 0
                ok_all &= ok
                dms = device_ms(run) or {}
                emit({"B": B, "R": R, "N": N, "stages": nst,
                      "chunk_tiles": ct, "nch": nch,
                      "blocks_a_pass": B * nrt * nch, "plan": ct == plan_ct,
                      "device_ms": dms.get("total"),
                      "pass_ms": {k: v for k, v in sorted(dms.items())
                                  if "sinkhorn_bf16<" in k},
                      "ms": cuda_ms(run, iters=args.iters),
                      "max_abs_err": max(float((kv - pv).abs().max()),
                                         float((kc - pc).abs().max())),
                      "unexplained_mismatch": unexplained, "ok": ok}, log)
                del buf
        # the production wrapper: the launcher's own choice
        def prod():
            return KE.fused_sinkhorn_match(a, b, alpha, iters)
        dms = device_ms(prod) or {}
        emit({"B": B, "production": [list(x) for x in
                                     KE.sinkhorn_plan(B, L, L, sms)],
              "device_ms": dms.get("total"), "kernels": dms,
              "ms": cuda_ms(prod, iters=args.iters)}, log)
        del a, b, pv, pj, pc, p0, p1
        torch.cuda.empty_cache()
    if log is not None:
        log.close()
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
