"""Minimal two-image matching example on the port (the JAX package's
``examples/match_pair.py``; the reference's
notebooks/demo_single_pair.ipynb as a script).

Usage:
  python -m loftr_tpu_torch.examples.match_pair img0.jpg img1.jpg \\
      [--ckpt weights/indoor_ds_new.ckpt] [--out matches.png]

It runs on the CUDA device; ``--device cpu`` runs the plain PyTorch path on
the CPU.  The figure needs ``matplotlib``.  ``main(argv)`` runs in-process
and returns ``api.match_pair``'s dict.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m loftr_tpu_torch.examples.match_pair",
        description=__doc__)
    p.add_argument("img0")
    p.add_argument("img1")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--preset", default="indoor_ds")
    p.add_argument("--resize", type=int, nargs=2, default=(640, 480))
    p.add_argument("--out", default="matches.png")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    args = p.parse_args(argv)

    import cv2

    from loftr_tpu_torch.api import load_matcher, match_pair
    from loftr_tpu_torch.utils.plotting import (dynamic_alpha, error_colormap,
                                                make_matching_figure)

    def g(f):
        return cv2.resize(cv2.imread(f, cv2.IMREAD_GRAYSCALE),
                          tuple(args.resize))

    img0, img1 = g(args.img0), g(args.img1)
    if not args.ckpt:
        print("WARNING: random weights (pass --ckpt for real matching)")
    matcher = load_matcher(args.ckpt, preset=args.preset, device=args.device)
    res = match_pair(img0, img1, matcher)
    k0, k1, conf = res["mkpts0"], res["mkpts1"], res["mconf"]
    print(f"{len(k0)} matches (mean confidence "
          f"{conf.mean() if len(conf) else 0:.3f})")

    color = error_colormap(1 - conf, 1.0, alpha=dynamic_alpha(len(k0)))
    make_matching_figure(img0, img1, k0, k1, color,
                         text=["loftr_tpu_torch", f"#Matches {len(k0)}"],
                         path=args.out)
    print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
