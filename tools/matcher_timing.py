#!/usr/bin/env python3
"""Time one kernel of one source tree on one CUDA card, the same way for
any tree, so two commits compare within one call.

    python3 tools/matcher_timing.py --kernel {dual_softmax,sinkhorn,focal_loss,
                                              window_attention,upsample}
                                    [--tree DIR] [--iters 20] [--out FILE]

Imports ``loftr_tpu_torch`` from DIR (default: this repository), so its
kernels build from DIR's sources into DIR's ``build/``.  bf16, unmasked:

- ``dual_softmax``: kernel B, ``fused_dual_softmax_match`` at temperature
  0.1 over seeded features with 400 planted correspondences a pair, at the
  main path's two launches [1,4800,256] (``match_pair``) and [8,4800,256]
  (the batched forward);
- ``sinkhorn``: kernel E, ``fused_sinkhorn_match`` with 3 iterations,
  ``bin_score`` 1.5 and ``prefilter`` off and on, over seeded features with
  1500 planted correspondences a pair (``chip_smoke.ot_case``), at the same
  two launches;
- ``focal_loss``: kernel D, ``fused_focal_sums`` at temperature 0.1, the
  forward without a graph and the forward with the backward (the gradients
  of pos + neg), over ``chip_smoke.focal_case`` features with 1500 planted
  ground-truth pairs, at [1,4800,256] (one pair) and [2,4800,256] (the
  training batch);
- ``window_attention``: kernel F, ``window_linear_attention`` with 8 heads
  over seeded q = k = v [NB, 25, 128] (the fine stack's launches: self at
  NB = 2048, both images packed, and cross at 1024);
- ``upsample``: kernel G, ``upsample2x`` over seeded [2,196,120,160] and
  [2,256,60,80] maps (the backbone's two sites at 640x480, B=1).

``ms`` is CUDA events around back-to-back calls (host included),
``device_ms`` the profiler's device time per call (every kernel of the
call), and ``kernels`` the profiler's kernels by name.  Prints one JSON
object per shape (and switch) with the card's name and power limit; exits 2
without CUDA.  Compare two trees by running them alternately in one call
(parent, change, change, parent).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dual_softmax_cases(rng, B, L, C, dev):
    """(record keys, call) pairs of kernel B at [B, L, C]."""
    import torch
    from loftr_tpu_torch.ops.kernels import dual_softmax as KB
    f0 = rng.randn(B, L, C).astype("float32")
    f1 = rng.randn(B, L, C).astype("float32")
    for b in range(B):
        i, j = rng.permutation(L)[:400], rng.permutation(L)[:400]
        f1[b, j] = f0[b, i] + 0.1 * rng.randn(400, C)
    a = torch.from_numpy(f0).to(dev, torch.bfloat16)
    bb = torch.from_numpy(f1).to(dev, torch.bfloat16)
    return [({}, lambda: KB.fused_dual_softmax_match(a, bb, 0.1))]


def sinkhorn_cases(rng, B, L, C, dev):
    """(record keys, call) pairs of kernel E at [B, L, C], prefilter off
    and on."""
    import torch
    from chip_smoke import ot_case
    from loftr_tpu_torch.ops.kernels import sinkhorn as KE
    f0, f1 = ot_case(rng, B, L, C, 1500)
    a = torch.from_numpy(f0).to(dev, torch.bfloat16)
    b = torch.from_numpy(f1).to(dev, torch.bfloat16)
    alpha = torch.tensor(1.5, device=dev)
    return [({"prefilter": pf},
             lambda pf=pf: KE.fused_sinkhorn_match(a, b, alpha, 3,
                                                   prefilter=pf))
            for pf in (False, True)]


def focal_loss_cases(rng, B, L, C, dev):
    """(record keys, call) pairs of kernel D at [B, L, C]: the forward
    without a graph, and forward + backward."""
    import torch
    from chip_smoke import focal_case
    from loftr_tpu_torch.ops.kernels import focal_loss as KD
    f0, f1, gt_j, gt_valid = focal_case(rng, B, L, C, 1500)
    a = torch.from_numpy(f0).to(dev, torch.bfloat16).requires_grad_(True)
    b = torch.from_numpy(f1).to(dev, torch.bfloat16).requires_grad_(True)
    gj = torch.from_numpy(gt_j).to(dev)
    gv = torch.from_numpy(gt_valid).to(dev)

    def fwd():
        with torch.no_grad():
            KD.fused_focal_sums(a, b, gj, gv)

    def fwd_bwd():
        with torch.enable_grad():
            p, n = KD.fused_focal_sums(a, b, gj, gv)
            torch.autograd.grad(p.sum() + n.sum(), (a, b))
    return [({"pass": "forward"}, fwd),
            ({"pass": "forward_backward"}, fwd_bwd)]


def window_attention_cases(rng, NB, dev):
    """(record keys, call) pairs of kernel F at q = k = v [NB, 25, 128]."""
    import torch
    from loftr_tpu_torch.ops.kernels import window_attention as KF
    x = torch.from_numpy(rng.randn(NB, 25, 128).astype("float32")).to(
        dev, torch.bfloat16)
    return [({"shape": [NB, 25, 128]},
             lambda: KF.window_linear_attention(x, x, x, 8))]


def upsample_cases(rng, shape, dev):
    """(record keys, call) pairs of kernel G at one [B, C, H, W]."""
    import torch
    from loftr_tpu_torch.ops.kernels import upsample as KG
    x = torch.from_numpy(rng.randn(*shape).astype("float32")).to(
        dev, torch.bfloat16)
    return [({"shape": list(shape)}, lambda: KG.upsample2x(x))]


def coarse(cases):
    """Cases at [B, 4800, 256] for each batch size B."""
    return lambda rng, B, dev: [
        ({"shape": [B, 4800, 4800, 256], **keys}, run)
        for keys, run in cases(rng, B, 4800, 256, dev)]


CASES = {"dual_softmax": coarse(dual_softmax_cases),
         "sinkhorn": coarse(sinkhorn_cases),
         "focal_loss": coarse(focal_loss_cases),
         "window_attention": window_attention_cases,
         "upsample": upsample_cases}
SIZES = {"dual_softmax": (1, 8), "sinkhorn": (1, 8), "focal_loss": (1, 2),
         "window_attention": (2048, 1024),
         "upsample": ((2, 196, 120, 160), (2, 256, 60, 80))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", required=True, choices=sorted(CASES))
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("matcher_timing.py: no CUDA device", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, REPO)
    from chip_smoke import cuda_ms, device_ms
    from loftr_tpu_torch.ops.kernels import _build
    pkg = os.path.abspath(_build.__file__)
    for _ in range(4):
        pkg = os.path.dirname(pkg)
    assert pkg == tree, _build.__file__
    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    log = open(args.out, "a") if args.out else None
    for size in SIZES[args.kernel]:
        for keys, run in CASES[args.kernel](rng, size, dev):
            run()
            torch.cuda.synchronize()
            dms = device_ms(run) or {}
            rec = {"tree": tree, "kernel": args.kernel, "nvidia_smi": smi,
                   **keys,
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
