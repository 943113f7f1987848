"""Serving example on the port: stand up the micro-batching
``serve.MatchingService`` and push a concurrent burst of requests through
it (the JAX package's ``examples/serve.py``).

Usage:
    python -m loftr_tpu_torch.examples.serve img_dir/ \\
        [--weights weights/indoor_ds_new.ckpt]

Matches consecutive image pairs from a directory.  Without --weights,
random init is used (expect 0 matches: uniform confidence is below the 0.2
threshold; the plumbing is what's shown).  It runs on the CUDA device;
``--device cpu`` serves from the CPU.  ``main(argv)`` runs in-process and
returns the service's stats snapshot.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
import time

# the one padded input shape and the batch rungs: a deployment warms
# exactly the rungs it serves
BUCKET = (480, 640)
BATCH_SIZES = (1, 8)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m loftr_tpu_torch.examples.serve", description=__doc__)
    ap.add_argument("img_dir", help="directory of images; consecutive pairs")
    ap.add_argument("--weights", default=None,
                    help="a released .ckpt (random init without)")
    ap.add_argument("--preset", default="indoor_ds")
    ap.add_argument("--flush-ms", type=float, default=5.0)
    ap.add_argument("--min-conf", type=float, default=0.2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    import cv2

    from loftr_tpu_torch.api import load_matcher
    from loftr_tpu_torch.serve import MatchingService

    state = load_matcher(args.weights, preset=args.preset,
                         device=args.device).state_dict()
    paths = sorted(sum((glob.glob(os.path.join(args.img_dir, p))
                        for p in ("*.jpg", "*.png", "*.jpeg")), []))
    if len(paths) < 2:
        sys.exit(f"need >=2 images in {args.img_dir}")
    imgs = [cv2.imread(p, cv2.IMREAD_GRAYSCALE) for p in paths]

    with MatchingService(state, preset=args.preset, buckets=(BUCKET,),
                         batch_sizes=BATCH_SIZES,
                         flush_ms=args.flush_ms, device=args.device) as svc:
        print("warming up (one forward per batch rung)...")
        svc.warmup()
        t0 = time.time()
        futs = [svc.submit(imgs[i], imgs[i + 1], min_conf=args.min_conf)
                for i in range(len(imgs) - 1)]
        for i, f in enumerate(futs):
            r = f.result()
            print(f"{os.path.basename(paths[i])} <-> "
                  f"{os.path.basename(paths[i + 1])}: "
                  f"{len(r['mkpts0'])} matches")
        dt = time.time() - t0
        print(f"\n{len(futs)} pairs in {dt:.2f}s "
              f"({len(futs) / dt:.1f} pairs/s through the service)")
        stats = svc.stats.snapshot()
        print("stats:", stats)
    return stats


if __name__ == "__main__":
    main()
