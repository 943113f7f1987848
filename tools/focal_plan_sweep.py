#!/usr/bin/env python3
"""Kernel D's bfloat16 path at each gradient-grid tiling and chunk count,
and its loss pass at each chunk count, on one CUDA card.

    python3 tools/focal_plan_sweep.py [--iters 10] [--out FILE]

The production launcher takes one gradient-grid tiling (128 resident rows
a block, ``focal_loss.GRAD_COLS`` = 32 streamed rows a tile, all 256
output columns a block, 2 ring stages) and the chunks of ``grad_plan`` / ``loss_plan`` in
``ops/kernels/focal_loss.py``.  This tool compiles ``csrc/focal_loss.cu``
once more, into ``build/focal_plan_sweep/<hash>/``, inside a small source
that adds one C entry point taking the tiling (streamed rows a tile 8 NJ,
output columns a block NOUT, ring stages NST) and both grids' chunk sizes,
so the measurement needs no switch in the production code.  At
[1,4800,256] and [2,4800,256] (bf16, unmasked, ``chip_smoke.focal_case``
features, cotangents 1 and 1) it

- runs the production forward once (prescale, statistics, loss pass with
  the class-split sums), then for each tiling and each of a few chunk
  counts (the same in both grids, as L = S) the two gradient grids and
  their combine: holds dfeat0 and dfeat1 against ``focal_sums_plain``'s
  autograd gradients (8e-3 of the entry plus 2e-3 of the pair's largest
  entry, as chip_smoke.py phase 2) and times them: ``device_ms`` from the
  profiler (both grids and the combine), ``ms`` by CUDA events;
- times the loss pass (with the class-split sums) and its combine through
  the production entry at each chunk count, holding pos and neg to the
  plain version (2e-4 relative).

It also prints each instantiation's registers and spills from the build's
``ptxas -v`` log, and the chunk counts ``grad_plan`` and ``loss_plan``
pick.  One JSON object a line; exits 1 if a case disagrees, 2 without
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
# (n8 tiles a warp NJ: 8 NJ streamed rows a tile; output columns a block
# NOUT; ring stages NST)
CONFIGS = ((8, 256, 2), (8, 128, 2), (4, 256, 2), (8, 256, 3), (16, 128, 2))
CHUNKS = (1, 2, 3, 4, 5, 6, 8, 10, 13, 19)   # chunks a grid (nch) to try

SWEEP_CU = r"""
#include "focal_loss.cu"

// Kernel D's two gradient grids and their combine with the tiling given by
// the caller.
extern "C" int loftr_focal_grad_cfg(
    const void* f0, const void* f1, const void* m0, const void* m1,
    const void* rstat, const void* cstat, const void* srow2,
    const void* scol2, const void* gtj, const void* gtv, const void* gpos,
    const void* gneg, void* part0, void* part1, void* df0, void* df1, int B,
    int L, int S, int nj, int nout, int nst, int ct0, int ct1,
    float grad_scale, float alpha, float gamma, void* stream) {
  using loftr::ring::bf16;
#define CASE(J, O, N)                                                      \
  if (nj == J && nout == O && nst == N)                                    \
    return loftr::bf::launch_grad<J, O, N>(                                \
        (const bf16*)f0, (const bf16*)f1, (const float*)m0,                \
        (const float*)m1, (const float*)rstat, (const float*)cstat,        \
        (const float*)srow2, (const float*)scol2, (const int*)gtj,         \
        (const float*)gtv, (const float*)gpos, (const float*)gneg,         \
        (float*)part0, (float*)part1, (bf16*)df0, (bf16*)df1, B, L, S,     \
        ct0, ct1, grad_scale, alpha, gamma, (cudaStream_t)stream);
  CASE(8, 256, 2)
  CASE(8, 128, 2)
  CASE(4, 256, 2)
  CASE(8, 256, 3)
  CASE(16, 128, 2)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
"""


def build():
    """Compile the sweep library; returns (ctypes library, ptxas log)."""
    from loftr_tpu_torch.ops.kernels import _build
    lib_path, log = _build.build_variant("focal_plan_sweep", SWEEP_CU)
    lib = ctypes.CDLL(lib_path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.loftr_focal_grad_cfg.argtypes = [P] * 16 + [I] * 8 + [F] * 3 + [P]
    lib.loftr_focal_grad_cfg.restype = I
    return lib, log


def registers(log):
    """{kernel<template arguments>: (registers, spill store bytes, spill
    load bytes)} of the bf16 loss and gradient kernels, from ``ptxas
    -v``."""
    regs, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(focal_loss_bf16|focal_grad_bf16)ILi(\d+)ELi(\d+)"
                          r"ELi(\d+)ELb(\d)ELb(\d)E", m.group(1))
            name = ("%s<%s>" % (k.group(1), ",".join(k.groups()[1:]))
                    if k else None)
            spill = (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = (int(m.group(1)), *spill)
    return regs


class _Ctx:
    """Stands in for autograd's ctx when the forward runs by hand."""

    def save_for_backward(self, *t):
        self.saved_tensors = t


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("focal_plan_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import cuda_ms, device_ms, emit, focal_case
    from loftr_tpu_torch.ops.kernels import _build
    from loftr_tpu_torch.ops.kernels import focal_loss as KD

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
    prod = _build.library()
    emit({"nvidia_smi": smi, "sms": sms,
          "registers_spills": registers(build_log)}, log)

    C, L, T = 256, 4800, 0.1
    rng = np.random.RandomState(0)
    p = ctypes.c_void_p
    st = p(_build.stream_ptr(torch.empty(1, device=dev)))
    ok_all = True
    for B in (1, 2):
        f0, f1, gt_j, gt_valid = focal_case(rng, B, L, C, 1500)
        a = torch.from_numpy(f0).to(dev, torch.bfloat16).requires_grad_(True)
        b = torch.from_numpy(f1).to(dev, torch.bfloat16).requires_grad_(True)
        gj = torch.from_numpy(gt_j).to(dev)
        gv = torch.from_numpy(gt_valid).to(dev)
        with torch.enable_grad():
            pp, pn = KD.focal_sums_plain(a, b, gj, gv, None, None, T)
            ref = torch.autograd.grad(pp.sum() + pn.sum(), (a, b))
        ref = [r.float() for r in ref]
        pp, pn = pp.detach(), pn.detach()
        ctx = _Ctx()
        with torch.no_grad():
            KD._FocalSums.forward(ctx, a.detach(), b.detach(), gj, gv, None,
                                  None, T, 0.25, 2.0, True)
        (x0, x1, _, _, rstat, cstat, srow2, scol2, gtj,
         gtv) = ctx.saved_tensors
        s, _ = KD.feature_scale(C, T)
        ones = torch.ones(B, device=dev)
        plan = KD.grad_plan(B, L, L, sms)
        emit({"B": B, "grad_plan": plan, "loss_plan": KD.loss_plan(
            B, L, L, sms)}, log)

        def grads_ok(d0, d1):
            return all(bool(((u - v).abs() <= 8e-3 * v.abs()
                             + 2e-3 * v.abs().max()).all())
                       for x, y in ((d0, ref[0]), (d1, ref[1]))
                       for u, v in zip(x.float(), y))

        for nj, nout, nst in CONFIGS:
            nct = math.ceil(L / (8 * nj))
            seen = set()
            for nch in CHUNKS:
                ct = math.ceil(nct / min(nch, nct))
                nch = math.ceil(nct / ct)
                if nch in seen:
                    continue
                seen.add(nch)
                part = (torch.empty((B, nch, L, C), dtype=torch.float32,
                                    device=dev) if nch > 1 else None)
                part1 = (torch.empty_like(part) if part is not None
                         else None)
                d0, d1 = torch.empty_like(x0), torch.empty_like(x1)
                ptrs = [p(None if t is None else t.data_ptr()) for t in (
                    x0, x1, None, None, rstat, cstat, srow2, scol2, gtj,
                    gtv, ones, ones, part, part1, d0, d1)]

                def run():
                    err = lib.loftr_focal_grad_cfg(
                        *ptrs, B, L, L, nj, nout, nst, ct, ct, s, 0.25, 2.0,
                        st)
                    _build.check(err, "loftr_focal_grad_cfg")
                run()
                torch.cuda.synchronize()
                ok = grads_ok(d0, d1)
                ok_all &= ok
                dms = device_ms(run, iters=args.iters) or {}
                emit({"B": B, "pass": "gradient", "NJ": nj, "N": 8 * nj,
                      "NOUT": nout, "NST": nst, "chunk_tiles": ct,
                      "nch": nch, "blocks": B * (256 // nout) * nch
                      * math.ceil(L / 128),
                      "plan": (nj, nout, nst) == (KD.GRAD_COLS // 8, 256,
                                                  2)
                      and ct == plan[0],
                      "device_ms": dms.get("total"),
                      "ms": cuda_ms(run, iters=args.iters), "ok": ok}, log)
                del part, part1, d0, d1

        # the loss pass (with the class-split sums) and its combine
        nct = math.ceil(L / 128)
        nrt = math.ceil(L / 128)
        lp = KD.loss_plan(B, L, L, sms)
        seen = set()
        for nch in CHUNKS:
            ct = math.ceil(nct / min(nch, nct))
            nch = math.ceil(nct / ct)
            if nch in seen:
                continue
            seen.add(nch)
            part = torch.empty((B * nrt * nch * 2,), device=dev)
            row_p = torch.empty((2 * B * nch * L,), device=dev)
            col_p = torch.empty((2 * B * nrt * L,), device=dev)
            pos, neg = (torch.empty(B, device=dev) for _ in range(2))
            s2r, s2c = (torch.empty(2 * B * L, device=dev) for _ in range(2))
            ptrs = [p(t.data_ptr()) for t in (
                x0, x1)] + [p(None), p(None)] + [p(t.data_ptr()) for t in (
                    rstat, cstat, gtj, gtv, part, row_p, col_p, pos, neg,
                    s2r, s2c)]

            def run_loss():
                err = prod.loftr_focal_bf16_fwd(*ptrs, B, L, L, ct, 0.25,
                                                2.0, 1, st)
                _build.check(err, "loftr_focal_bf16_fwd")
            run_loss()
            torch.cuda.synchronize()
            rel = max(float(((pos - pp).abs() / pp.abs()).max()),
                      float(((neg - pn).abs() / pn.abs()).max()))
            # the class-split row sums, summed over other chunks
            ok = rel <= 2e-4 and float((s2r - srow2).abs().max()) <= (
                1e-4 * float(srow2.abs().max()))
            ok_all &= ok
            dms = device_ms(run_loss, iters=args.iters) or {}
            emit({"B": B, "pass": "loss", "chunk_tiles": ct, "nch": nch,
                  "blocks": B * nrt * nch, "plan": ct == lp[0],
                  "device_ms": dms.get("total"),
                  "ms": cuda_ms(run_loss, iters=args.iters),
                  "sums_rel_err": rel, "ok": ok}, log)
        del a, b, ref, x0, x1
        torch.cuda.empty_cache()
    if log is not None:
        log.close()
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
