#!/usr/bin/env python3
"""Kernel B's bfloat16 path at each tile shape and column chunk, on one CUDA
card.

    python3 tools/dual_softmax_tile_sweep.py [--iters 20] [--out FILE]

The production launcher takes one tile shape (R = 128 rows of f0 resident,
N = 128 f1 rows a ring stage, 2 stages) and picks the column tiles a block
(``chunk_tiles``) with ``bf16_plan`` in ``ops/kernels/dual_softmax.py``.
This tool compiles ``csrc/dual_softmax.cu`` once more, into
``build/dual_softmax_tile_sweep/<hash>/``, inside a small source that adds
one C entry point taking the warp layout and ring depth, so the measurement
needs no switch in the production code.  For each shape (R x N, stages) and
each of a few chunk counts, at the main path's launches [1,4800,256] and
[8,4800,256] (unmasked, as ``match_pair`` calls it), it holds the outputs
against ``dual_softmax_plain`` at chip_smoke.py's bar (1e-6 + 1e-4 |ref| on
best_val and colconf, best_j equal outside near-ties) and times the call:
``device_ms`` from the profiler (both passes and the two combines),
``ms`` by CUDA events around back-to-back calls.  It also prints each
instantiation's registers and spills from the build's ``ptxas -v`` log, the
blocks an SM the shared memory allows, and the chunk count ``bf16_plan``
picks.  Then it runs the production wrapper (the launcher's choice) at both
shapes.  One JSON object a line; exits 1 if a case disagrees, 2 without
CUDA.
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
CONFIGS = ((4, 8, 2), (4, 4, 2), (4, 4, 3), (2, 4, 2), (2, 2, 2), (2, 2, 3))
CHUNKS = (1, 2, 3, 4, 6, 10, 19, 38)   # column chunks (nch) to try

SWEEP_CU = r"""
#include "dual_softmax.cu"

// Kernel B's bfloat16 path with the tile shape given by the caller.
extern "C" int loftr_dual_softmax_bf16_cfg(
    const void* f0, const void* f1, const void* m0, const void* m1,
    void* row_pa, void* row_pb, void* col_pa, void* col_pb, void* rstat,
    void* cstat, void* best_val, void* best_j, void* colconf, int B, int L,
    int S, int wr, int nj, int nst, int chunk_tiles, float scale,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CASE(A, J, N)                                                      \
  if (wr == A && nj == J && nst == N)                                      \
    return loftr::bf::launch<A, J, N>(f0, f1, m0, m1, row_pa, row_pb,      \
                                      col_pa, col_pb, rstat, cstat,        \
                                      best_val, best_j, colconf, B, L, S,  \
                                      chunk_tiles, scale, st);
  CASE(4, 8, 2)
  CASE(4, 4, 2)
  CASE(4, 4, 3)
  CASE(2, 4, 2)
  CASE(2, 2, 2)
  CASE(2, 2, 3)
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
    lib_path, log = _build.build_variant("dual_softmax_tile_sweep", SWEEP_CU)
    lib = ctypes.CDLL(lib_path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.loftr_dual_softmax_bf16_cfg.argtypes = [P] * 13 + [I] * 7 + [F, P]
    lib.loftr_dual_softmax_bf16_cfg.restype = I
    return lib, log


def registers(log):
    """{"WR,NJ,NST,MODE": (registers, spill store bytes, spill load bytes)}
    of the bf16 pass kernels, from ``ptxas -v``."""
    regs, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"dual_softmax_bf16ILi(\d)ELi(\d)ELi(\d)ELi(\d)E",
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
        print("dual_softmax_tile_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms, device_ms, emit, rel_gap_top2
    from loftr_tpu_torch.ops.kernels import dual_softmax as KB

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
    smem_sm = 233472
    blocks = {}
    for cfg in CONFIGS:
        R, N, nst = shape_of(cfg)
        red = max(2 * cfg[0] * N, 2 * R * (8 // cfg[0]))
        smem = (R + nst * N) * (256 + 8) * 2 + red * 4
        blocks[",".join(map(str, cfg))] = {
            "R": R, "N": N, "stages": nst, "smem_bytes": smem,
            "blocks_per_sm": smem_sm // (smem + 1024)}
    emit({"nvidia_smi": smi, "sms": sms, "configs": blocks,
          "registers_spills": registers(build_log)}, log)

    C, L = 256, 4800
    rng = np.random.RandomState(0)
    p = ctypes.c_void_p
    ok_all = True
    for B in (1, 8):
        f0 = rng.randn(B, L, C).astype(np.float32)
        f1 = rng.randn(B, L, C).astype(np.float32)
        for b in range(B):
            ii, jj = rng.permutation(L)[:400], rng.permutation(L)[:400]
            f1[b, jj] = f0[b, ii] + 0.1 * rng.randn(400, C)
        a = torch.from_numpy(f0).to(dev, torch.bfloat16)
        bb = torch.from_numpy(f1).to(dev, torch.bfloat16)
        pv, pj, pc = KB.dual_softmax_plain(a, bb, 0.1)
        conf = torch.stack([torch.softmax(s, 1) * torch.softmax(s, 0) for s in
                            torch.matmul(a.float(), bb.float().transpose(1, 2))
                            / (C * 0.1)])
        near = rel_gap_top2(conf) < 1e-6
        del conf
        for cfg in CONFIGS:
            R, N, nst = shape_of(cfg)
            nrt, nct = math.ceil(L / R), math.ceil(L / N)
            plan_ct = KB.bf16_plan(B, L, L, sms, R, N)[2]
            cts = sorted({math.ceil(nct / n) for n in CHUNKS if n <= nct}
                         | {plan_ct}, reverse=True)
            for ct in cts:
                nch = math.ceil(nct / ct)
                sizes = (B * nch * L, B * nch * L, B * nrt * L, B * nrt * L,
                         2 * B * L, 2 * B * L)
                scratch = torch.empty(sum(sizes), dtype=torch.float32,
                                      device=dev).split(sizes)
                bv = torch.empty((B, L), dtype=torch.float32, device=dev)
                bj = torch.empty((B, L), dtype=torch.int32, device=dev)
                cc = torch.empty((B, L), dtype=torch.float32, device=dev)
                ptrs = [p(t.data_ptr()) for t in (a, bb)] + [p(None)] * 2 + [
                    p(t.data_ptr()) for t in (*scratch, bv, bj, cc)]

                def run():
                    err = lib.loftr_dual_softmax_bf16_cfg(
                        *ptrs, B, L, L, *cfg, ct, 1.0 / (C * 0.1),
                        p(torch.cuda.current_stream().cuda_stream))
                    if err:
                        raise RuntimeError(f"launch error {err}")
                run()
                torch.cuda.synchronize()
                okv = bool(((bv - pv).abs() <= 1e-6 + 1e-4 * pv.abs()).all())
                okc = bool(((cc - pc).abs() <= 1e-6 + 1e-4 * pc.abs()).all())
                unexplained = int(((bj != pj) & ~near).sum())
                ok = okv and okc and unexplained == 0
                ok_all &= ok
                dms = device_ms(run) or {}
                emit({"B": B, "R": R, "N": N, "stages": nst,
                      "chunk_tiles": ct, "nch": nch,
                      "blocks": B * nrt * nch,
                      "waves": B * nrt * nch / (sms * blocks[",".join(
                          map(str, cfg))]["blocks_per_sm"]),
                      "plan": ct == plan_ct,
                      "device_ms": dms.get("total"),
                      "pass_ms": [v for k, v in sorted(dms.items())
                                  if "dual_softmax_bf16<" in k],
                      "ms": cuda_ms(run, iters=args.iters),
                      "max_abs_err": max(float((bv - pv).abs().max()),
                                         float((cc - pc).abs().max())),
                      "unexplained_mismatch": unexplained, "ok": ok}, log)
        # the production wrapper: the launcher's own choice
        def prod():
            return KB.fused_dual_softmax_match(a, bb, 0.1)
        dms = device_ms(prod) or {}
        emit({"B": B, "production": list(KB.bf16_plan(B, L, L, sms)),
              "device_ms": dms.get("total"), "kernels": dms,
              "ms": cuda_ms(prod, iters=args.iters)}, log)
        del a, bb, pv, pj, pc
        torch.cuda.empty_cache()
    if log is not None:
        log.close()
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
