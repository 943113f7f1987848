"""Streaming matching demo on the port: ``python -m loftr_tpu_torch.demo``
(the JAX package's ``demo/demo_loftr.py``; the reference's
demo/demo_loftr.py:30-241).

Matches every frame of a video / image directory / camera against a
reference frame and writes each pair's figure, matches colored by
confidence, to ``--output`` (headless: no display; ``--ref-frame`` selects
the anchor where the reference uses a hotkey).

Usage:
  python -m loftr_tpu_torch.demo --input /path/to/dir_or_video \\
      [--ckpt weights/indoor_ds.ckpt] [--output out/] [--resize 640 480]

It runs on the CUDA device; ``--device cpu`` runs the plain PyTorch path on
the CPU (without it, a host with no CUDA device raises).  The figures need
``matplotlib``.  ``main(argv)`` runs in-process and returns the written
paths.
"""
from __future__ import annotations

import argparse
import glob
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m loftr_tpu_torch.demo",
                                description=__doc__)
    p.add_argument("--input", required=True,
                   help="image dir, video file, or camera index")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--preset", default="indoor_ds")
    p.add_argument("--output", default="demo_out")
    p.add_argument("--resize", type=int, nargs=2, default=(640, 480))
    p.add_argument("--ref-frame", type=int, default=0,
                   help="index of the anchor frame")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--thr", type=float, default=None)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="bfloat16 = deployment; float32 = full precision")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    return p.parse_args(argv)


class FrameSource:
    """Frames from a directory, video file, or camera (the demo's
    VideoStreamer)."""

    def __init__(self, spec: str, resize):
        import cv2
        self.cv2 = cv2
        self.resize = tuple(resize)
        if os.path.isdir(spec):
            exts = ("*.jpg", "*.png", "*.jpeg", "*.JPG")
            self._files = sorted(sum([glob.glob(os.path.join(spec, e))
                                      for e in exts], []))
            self._cap = None
        else:
            self._files = None
            self._cap = cv2.VideoCapture(int(spec) if spec.isdigit()
                                         else spec)

    def __iter__(self):
        if self._files is not None:
            for f in self._files:
                img = self.cv2.imread(f, self.cv2.IMREAD_GRAYSCALE)
                if img is not None:
                    yield self.cv2.resize(img, self.resize)
        else:
            while True:
                ok, frame = self._cap.read()
                if not ok:
                    return
                gray = self.cv2.cvtColor(frame, self.cv2.COLOR_BGR2GRAY)
                yield self.cv2.resize(gray, self.resize)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from loftr_tpu_torch.api import load_matcher, resolve_device, with_config
    from loftr_tpu_torch.structs import MatchInput
    from loftr_tpu_torch.utils.plotting import (dynamic_alpha, error_colormap,
                                                make_matching_figure)

    dev = resolve_device(args.device)
    coarse = {"use_pallas": True}
    if args.thr is not None:
        coarse["thr"] = args.thr
    if not args.ckpt:
        print("WARNING: random weights (no --ckpt)")
    model = with_config(load_matcher(args.ckpt, preset=args.preset,
                                     device=dev),
                        {"dtype": args.dtype, "match_coarse": coarse})

    frames = list(FrameSource(args.input, args.resize))
    if args.max_frames:
        frames = frames[: args.max_frames]
    if not frames:
        raise FileNotFoundError(f"no frames found at {args.input}")
    ref = frames[args.ref_frame]

    def gray(x):
        return (torch.from_numpy(x).to(dev, torch.float32)[None, :, :, None]
                / 255.0)

    os.makedirs(args.output, exist_ok=True)
    paths = []
    for idx, frame in enumerate(frames):
        if idx == args.ref_frame:
            continue
        with torch.inference_mode():
            out = model(MatchInput(image0=gray(ref), image1=gray(frame)))
        valid = out.valid[0].cpu().numpy()
        k0 = out.mkpts0_f[0].float().cpu().numpy()[valid]
        k1 = out.mkpts1_f[0].float().cpu().numpy()[valid]
        conf = out.coarse.mconf[0].float().cpu().numpy()[valid]
        # color by confidence (demo_loftr.py visualization flavor)
        color = error_colormap(1.0 - conf, 1.0, alpha=dynamic_alpha(len(k0)))
        path = os.path.join(args.output, f"match_{idx:05d}.png")
        make_matching_figure(ref, frame, k0, k1, color,
                             text=[f"frame {idx}", f"#Matches {len(k0)}"],
                             path=path)
        print(f"frame {idx}: {len(k0)} matches -> {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
