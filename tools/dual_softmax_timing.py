#!/usr/bin/env python3
"""Time kernel B (the dual-softmax matcher) of one source tree on one CUDA
card, the same way for any tree, so two commits compare within one call.

    python3 tools/dual_softmax_timing.py [--tree DIR] [--iters 20]
                                         [--out FILE]

Imports ``loftr_tpu_torch`` from DIR (default: this repository), so its
kernels build from DIR's sources into DIR's ``build/``.  At the main path's
two launches, [1,4800,256] (``match_pair``) and [8,4800,256] (the batched
forward), bf16, unmasked, seeded features with planted correspondences, it
times ``fused_dual_softmax_match``: ``ms`` by CUDA events around
back-to-back calls (host included), ``device_ms`` the profiler's device time
per call (every kernel of the call), and the profiler's kernels by name.
Prints one JSON object per shape with the card's name and power limit;
exits 2 without CUDA.  Compare two trees by running them alternately in one
call (parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("dual_softmax_timing.py: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, REPO)
    from chip_smoke import cuda_ms, device_ms
    from loftr_tpu_torch.ops.kernels import dual_softmax as KB
    pkg = os.path.abspath(KB.__file__)
    for _ in range(4):
        pkg = os.path.dirname(pkg)
    assert pkg == tree, KB.__file__
    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    C, L = 256, 4800
    log = open(args.out, "a") if args.out else None
    for B in (1, 8):
        f0 = rng.randn(B, L, C).astype(np.float32)
        f1 = rng.randn(B, L, C).astype(np.float32)
        for b in range(B):
            i, j = rng.permutation(L)[:400], rng.permutation(L)[:400]
            f1[b, j] = f0[b, i] + 0.1 * rng.randn(400, C)
        a = torch.from_numpy(f0).to(dev, torch.bfloat16)
        bb = torch.from_numpy(f1).to(dev, torch.bfloat16)

        def run():
            return KB.fused_dual_softmax_match(a, bb, 0.1)
        run()
        torch.cuda.synchronize()
        dms = device_ms(run) or {}
        rec = {"tree": tree, "nvidia_smi": smi, "shape": [B, L, L, C],
               "ms": cuda_ms(run, iters=args.iters),
               "device_ms": dms.get("total"), "kernels": dms}
        line = json.dumps(rec)
        print(line, flush=True)
        if log is not None:
            log.write(line + "\n")
    if log is not None:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
