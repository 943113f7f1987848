"""SfM entry point on the port: ``python -m loftr_tpu_torch.sfm``.

The counterpart of the JAX package's top-level ``sfm.py``: a keyframed
trajectory from an image sequence.  Runs the LoFTR matcher over keyframe
pairs of a ScanNet-style sequence directory (color/*.jpg [+ depth/*.png in
mm] [+ pose/*.txt cam2world for the ATE]), builds the pose graph, runs
Schur-complement bundle adjustment, and prints the report as one JSON line
(``scene``, ``n_frames``, ``n_keyframes``, ``n_edges``, ``ba_cost``, and
``ate`` when ``pose/`` exists).

Usage:
  python -m loftr_tpu_torch.sfm --scene-dir data/scannet/test/scene0707_00 \\
      --intrinsic <K.npz-or-txt> --ckpt weights/indoor_ds.ckpt \\
      [--keyframe-stride 10] [--max-frames 200] [--out traj.npz]

It runs on the CUDA device; ``--device cpu`` runs the plain PyTorch path on
the CPU (without it, a host with no CUDA device raises).  The matcher runs
in bfloat16 with the matcher kernel on, under ``torch.inference_mode``.
``main(argv)`` runs in-process and returns the report; ``profiler`` (a
``utils.profiler.RegionProfiler``) times its stages.
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m loftr_tpu_torch.sfm",
                                description=__doc__)
    p.add_argument("--scene-dir", required=True)
    p.add_argument("--intrinsic", required=True,
                   help="intrinsics: .npz (scene->K), .txt (ScanNet "
                        "intrinsic file), or 'fx,fy,cx,cy'")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--preset", default="indoor_ds")
    p.add_argument("--keyframe-stride", type=int, default=10)
    p.add_argument("--link-range", type=int, default=2)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--ba-iters", type=int, default=15)
    p.add_argument("--ba-solver", default="dense", choices=["dense", "pcg"],
                   help="reduced-camera-system solver (pcg: matrix-free, "
                        "for large keyframe counts)")
    p.add_argument("--resize", type=int, nargs=2, default=(640, 480))
    p.add_argument("--no-depth", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    return p.parse_args(argv)


def load_intrinsic(spec: str, scene: str):
    import numpy as np
    if spec.endswith(".npz"):
        d = dict(np.load(spec))
        return np.asarray(d.get(scene, list(d.values())[0]), np.float64)
    if spec.endswith(".txt"):
        K = np.loadtxt(spec, delimiter=" ")
        return K[:3, :3]
    fx, fy, cx, cy = map(float, spec.split(","))
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])


def main(argv=None, profiler=None) -> dict:
    args = parse_args(argv)
    import cv2
    import numpy as np
    import torch

    from loftr_tpu_torch.api import load_matcher, resolve_device, with_config
    from loftr_tpu_torch.data.io import read_scannet_depth, read_scannet_pose
    from loftr_tpu_torch.sfm.ate import (absolute_trajectory_error,
                                         camera_centers)
    from loftr_tpu_torch.sfm.pipeline import run_sfm
    from loftr_tpu_torch.structs import MatchInput
    from loftr_tpu_torch.utils.profiler import RegionProfiler

    dev = resolve_device(args.device)
    prof = profiler or RegionProfiler(enabled=False)
    scene = os.path.basename(args.scene_dir.rstrip("/"))
    color_files = sorted(
        glob.glob(os.path.join(args.scene_dir, "color", "*.jpg")),
        key=lambda f: int(os.path.splitext(os.path.basename(f))[0]))
    if args.max_frames:
        color_files = color_files[: args.max_frames]
    if not color_files:
        raise FileNotFoundError(f"no frames in {args.scene_dir}/color")
    W, H = args.resize
    with prof.profile("sfm/load"):
        frames = [cv2.resize(cv2.imread(f, cv2.IMREAD_GRAYSCALE), (W, H))
                  for f in color_files]
        stems = [os.path.splitext(os.path.basename(f))[0]
                 for f in color_files]

        K = load_intrinsic(args.intrinsic, scene)
        # scale K to the resize (ScanNet color is 1296x968 or 640x480)
        probe = cv2.imread(color_files[0], cv2.IMREAD_GRAYSCALE)
        K = K.copy()
        K[0] *= W / probe.shape[1]
        K[1] *= H / probe.shape[0]

        depths = None
        if not args.no_depth and \
                os.path.isdir(os.path.join(args.scene_dir, "depth")):
            depths = []
            for stem in stems:
                p = os.path.join(args.scene_dir, "depth", f"{stem}.png")
                d = read_scannet_depth(p) if os.path.exists(p) else None
                if d is not None and d.shape != (H, W):
                    d = cv2.resize(d, (W, H),
                                   interpolation=cv2.INTER_NEAREST)
                depths.append(d)

    if not args.ckpt:
        print("WARNING: random weights (no --ckpt); expect no matches")
    matcher = load_matcher(args.ckpt, preset=args.preset, device=dev)
    model = with_config(matcher, {"dtype": "bfloat16",
                                  "match_coarse": {"use_pallas": True}})

    def gray(x):
        return (torch.from_numpy(x).to(dev, torch.float32)[None, :, :, None]
                / 255.0)

    def match_fn(a, b):
        with torch.inference_mode():
            out = model(MatchInput(image0=gray(frames[a]),
                                   image1=gray(frames[b])))
            v = out.valid[0].cpu().numpy()
            return (out.mkpts0_f[0].float().cpu().numpy()[v],
                    out.mkpts1_f[0].float().cpu().numpy()[v],
                    out.coarse.i_ids[0].cpu().numpy()[v],
                    out.coarse.j_ids[0].cpu().numpy()[v])

    out = run_sfm(len(frames), match_fn, K, depths=depths,
                  keyframe_stride=args.keyframe_stride,
                  link_range=args.link_range, ba_iters=args.ba_iters,
                  ba_solver=args.ba_solver, device=dev, profiler=prof)
    kfs = out["keyframes"]
    report = {"scene": scene, "n_frames": len(frames),
              "n_keyframes": len(kfs), "n_edges": len(out["edges"]),
              "ba_cost": out["ba_cost"]}

    pose_dir = os.path.join(args.scene_dir, "pose")
    if os.path.isdir(pose_dir):
        gt_R, gt_t, ok = [], [], []
        for k in kfs:
            p = os.path.join(pose_dir, f"{stems[k]}.txt")
            if os.path.exists(p):
                T = read_scannet_pose(p)  # world2cam
                gt_R.append(T[:3, :3])
                gt_t.append(T[:3, 3])
                ok.append(True)
            else:
                ok.append(False)
        if sum(ok) >= 3:
            sel = np.nonzero(ok)[0]
            est = camera_centers(out["R"][sel], out["t"][sel])
            gt = camera_centers(np.asarray(gt_R), np.asarray(gt_t))
            report["ate"] = absolute_trajectory_error(est, gt)
    print(json.dumps(report))
    if args.out:
        np.savez(args.out, keyframes=np.asarray(kfs), R=out["R"], t=out["t"])
    return report


if __name__ == "__main__":
    main()
