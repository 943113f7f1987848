"""Multi-seed statistics of the synthetic-AUC benchmark on the port; the
counterpart of the JAX package's ``tools/seed_sweep.py``.

For each seed: generate a fresh scene set (``synthetic_benchmark``'s
generator, 6 train / 3 held-out scenes of 12 views, 63 eval pairs), then
train both predicted-slot sampling semantics (``per_pair``, the default,
and ``global_replacement``, the reference's batch-global emulation,
coarse_matching.py:198-236) on identical data and evaluate each through
the port's eval CLI.  Outputs the per-arm mean, spread, min, max and
per-seed values of AUC@{5,10,20} and precision, and the paired per-seed
deltas when both arms ran, under the JAX tool's keys.

Beyond the JAX tool: ``--eval-untrained`` evaluates the random-init
control on each seed's held-out set; the evaluations run in float32 with
TF32 off (``evaluate_cli``), and each trained model is also evaluated with
PyTorch's default TF32 (under ``tf32_eval``), with the port's device
solver (``batched``, under that key), and its
coarse cells inside the focal loss's clamp (1e-6, 1 - 1e-6) on the
held-out pairs are counted (``live_cells``: the cells kernel D's loss pass
takes its rare path for); the artifact also records the card
(``nvidia-smi`` name and power limit), the TF32 flags and the kernel
launches of training and of the live-cell forward.

Usage (on the card, a few minutes a seed and arm):
  python -m loftr_tpu_torch.tools.seed_sweep --seeds 0 1 2 \\
      --eval-untrained --depth-format npy --out perf/torch_synthetic_auc.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import os.path as osp
import subprocess
import tempfile
import time

import numpy as np

from loftr_tpu_torch.tools.synthetic_benchmark import (REPO, SMALL_MODEL,
                                                       evaluate_cli,
                                                       generate_data,
                                                       save_untrained, train)

METRICS = ("auc@5", "auc@10", "auc@20", "prec@1e-04")
CLAMP = 1e-6  # the focal loss's clamp (conf in (CLAMP, 1 - CLAMP) is live)


def summarize(runs, arms, seeds) -> dict:
    """Per-arm mean / std / min / max / per-seed of METRICS, and the paired
    per-seed deltas (per_pair - global_replacement) when both arms ran."""
    summary = {}
    for arm in arms:
        vals = {m: [r[m] for r in runs if r["arm"] == arm] for m in METRICS}
        summary[arm] = {
            m: {"mean": round(float(np.mean(v)), 4),
                "std": round(float(np.std(v)), 4),
                "min": round(float(np.min(v)), 4),
                "max": round(float(np.max(v)), 4),
                "per_seed": [round(float(x), 4) for x in v]}
            for m, v in vals.items()}
    if all(a in arms for a in ("per_pair", "global_replacement")):
        summary["paired_delta"] = {}
        for m in METRICS:
            d = [next(r[m] for r in runs
                      if r["seed"] == s and r["arm"] == "per_pair")
                 - next(r[m] for r in runs
                        if r["seed"] == s
                        and r["arm"] == "global_replacement")
                 for s in seeds]
            summary["paired_delta"][m] = {
                "mean": round(float(np.mean(d)), 4),
                "std": round(float(np.std(d)), 4),
                "per_seed": [round(float(x), 4) for x in d]}
    return summary


def live_cells(work_dir: str, test_idx: str, ckpt: str, img_resize: int,
               device) -> dict:
    """Share and count of the coarse confidence cells inside the focal
    clamp, per held-out pair (mean and max over pairs)."""
    import glob
    import torch
    from loftr_tpu_torch.config import get_config
    from loftr_tpu_torch.data import DataLoader, MegaDepthDataset
    from loftr_tpu_torch.data.sampler import ConcatDataset
    from loftr_tpu_torch.models.matcher import LoFTR
    from loftr_tpu_torch.train.checkpoint import load_params

    model = LoFTR(get_config("default", SMALL_MODEL).loftr)
    load_params(ckpt, model)
    model = model.eval().to(device)
    dss = [MegaDepthDataset(work_dir, n, mode="test", img_resize=img_resize,
                            df=8, img_padding=True)
           for n in sorted(glob.glob(osp.join(test_idx, "*.npz")))]
    shares, counts = [], []
    with torch.inference_mode():
        for inp, _ in DataLoader(ConcatDataset(dss), 1, num_workers=4,
                                 drop_last=False):
            conf = model(inp.to(device)).conf_matrix
            live = ((conf > CLAMP) & (conf < 1 - CLAMP)).sum().item()
            counts.append(live)
            shares.append(live / conf[0].numel())
    return {"pairs": len(shares), "cells_per_pair": int(conf[0].numel()),
            "mean_share": float(np.mean(shares)),
            "max_share": float(np.max(shares)),
            "mean_count": float(np.mean(counts)),
            "max_count": int(np.max(counts))}


def card_info(device) -> dict:
    """The device the sweep ran on, with the training's TF32 flags as they
    were and the evaluations' setting."""
    import torch
    info = {"device": str(device), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "tf32": {"cuda.matmul.allow_tf32":
                     torch.backends.cuda.matmul.allow_tf32,
                     "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32},
            "eval_tf32": "NVIDIA_TF32_OVERRIDE=0 (tf32_eval: the flags "
                         "above)"}
    if torch.device(device).type == "cuda":
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
        info["kind"] = torch.cuda.get_device_name(0)
    return info


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m loftr_tpu_torch.tools.seed_sweep",
        description=__doc__)
    ap.add_argument("--work-dir",
                    default=osp.join(tempfile.gettempdir(), "seedsweep"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--arms", nargs="+",
                    default=["per_pair", "global_replacement"])
    # the flagship config (the JAX package's perf/synthetic_auc.json)
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--img-resize", type=int, default=256)
    ap.add_argument("--train-scenes", type=int, default=6)
    ap.add_argument("--test-scenes", type=int, default=3)
    ap.add_argument("--views", type=int, default=12)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--eval-untrained", action="store_true",
                    help="also evaluate the random-init model on each "
                         "seed's held-out set (control)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cpu runs the plain PyTorch path")
    ap.add_argument("--depth-format", default="h5", choices=["h5", "npy"],
                    help="depth files of the synthetic scenes (npy: a host "
                         "without h5py)")
    ap.add_argument("--init-seeds", type=int, nargs="+", default=None,
                    help="one a --seeds entry: seeds the initial weights "
                         "and the selection draws apart from the data "
                         "(default: the data seed), so that one scene set "
                         "can be trained from several inits")
    ap.add_argument("--deterministic", action="store_true",
                    help="train under torch.use_deterministic_algorithms "
                         "(cuDNN's deterministic algorithms, a fixed cuBLAS "
                         "workspace; an op without a deterministic version "
                         "warns): repeats of one seed then show whether "
                         "their spread is the card's nondeterminism")
    ap.add_argument("--out", default=None,
                    help="artifact json (default "
                         "perf/torch_synthetic_auc.json)")
    return ap.parse_args(argv)


@contextlib.contextmanager
def deterministic(on: bool):
    """PyTorch's deterministic algorithms while the block runs, when
    ``on``; the previous settings are restored afterwards."""
    import torch
    if not on:
        yield
        return
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    # cuBLAS reads its workspace setting when a handle is made
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic = prev[2]
        torch.backends.cudnn.benchmark = prev[3]
        if prev[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev[4]


def main(argv=None) -> dict:
    args = parse_args(argv)
    from loftr_tpu_torch.api import resolve_device
    from loftr_tpu_torch.ops.kernels import (launch_counts,
                                             reset_launch_counts)
    device = resolve_device(args.device)
    init_seeds = args.init_seeds or args.seeds
    if len(init_seeds) != len(args.seeds):
        raise ValueError("--init-seeds needs one entry a --seeds entry")

    with deterministic(args.deterministic):
        t0 = time.time()
        runs = []
        for seed, init_seed in zip(args.seeds, init_seeds):
            wd = osp.join(args.work_dir, f"seed{seed}")
            os.makedirs(wd, exist_ok=True)
            train_npzs, test_idx = generate_data(
                wd, args.train_scenes, args.test_scenes, args.views,
                args.img_size, seed, depth_format=args.depth_format)
            untrained = None
            if args.eval_untrained:
                untrained = evaluate_cli(wd, test_idx, save_untrained(wd),
                                         args.img_resize, device=device)
                print(f"seed {seed} untrained: {untrained}", flush=True)
            for arm in args.arms:
                print(f"=== seed {seed} arm {arm} ===", flush=True)
                reset_launch_counts()
                t = time.time()
                ckpt, losses = train(
                    wd, train_npzs, args.img_size, args.img_resize,
                    args.steps, args.batch, args.lr, seed,
                    train_sampling=arm, ckpt_name=f"ckpt_{arm}",
                    device=device, init_seed=init_seed)
                train_s = time.time() - t
                launches = {"train": launch_counts()}
                res = evaluate_cli(wd, test_idx, ckpt, args.img_resize,
                                   device=device)
                run = {"seed": seed, "init_seed": init_seed, "arm": arm,
                       **res,
                       "final_loss_per50": round(
                           float(np.mean(losses[-50:])), 4),
                       "train_loss_first20": round(
                           float(np.mean(losses[:20])), 4),
                       "train_loss_last20": round(
                           float(np.mean(losses[-20:])), 4),
                       "train_s": round(train_s, 1)}
                if untrained is not None:
                    run["untrained"] = untrained
                run["tf32_eval"] = evaluate_cli(wd, test_idx, ckpt,
                                                args.img_resize, device=device,
                                                tf32=True)
                run["batched"] = evaluate_cli(wd, test_idx, ckpt,
                                              args.img_resize, "batched",
                                              device=device)
                reset_launch_counts()
                run["live_cells"] = live_cells(wd, test_idx, ckpt,
                                               args.img_resize, device)
                launches["live_cell_forward"] = launch_counts()
                run["kernel_launches"] = launches
                runs.append(run)
                print(runs[-1], flush=True)

    summary = summarize(runs, args.arms, args.seeds)
    artifact = {"config": vars(args), "card": card_info(device),
                "runs": runs, "summary": summary,
                "wall_s": round(time.time() - t0, 1)}
    out = args.out or osp.join(REPO, "perf", "torch_synthetic_auc.json")
    os.makedirs(osp.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(artifact, f, indent=1)
    print("wrote", out)
    print(json.dumps(summary, indent=1))
    return artifact


if __name__ == "__main__":
    main()
