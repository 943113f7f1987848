"""Benchmark evaluation entry point (ScanNet-1500 / MegaDepth-1500) on the
port; the counterpart of the JAX package's ``test.py``, with its flags and
its printed JSON keys.

Usage:
  python -m loftr_tpu_torch.test --preset scannet_eval --dataset scannet \\
      --data-root data/scannet/test \\
      --npz-path assets/scannet_test_1500/test.npz \\
      --intrinsic-path assets/scannet_test_1500/intrinsics.npz \\
      --ckpt weights/indoor_ds.ckpt [--thr 0.2] \\
      [--pose-solver opencv|native|5pt|batched|batched5pt] [--device cuda]

Runs on the CUDA device; ``--device cpu`` runs the plain PyTorch path on
the CPU (without it, a host with no CUDA device raises).  ``--ckpt`` takes
a reference ``.ckpt`` or a checkpoint of the port's own
(``train/checkpoint.py``: a ``save_params`` file, a checkpoint file of
``CheckpointManager`` or its directory, whose latest kept step loads).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default=None,
                   help="named preset (default scannet_eval; config files "
                        "may also set preset:)")
    p.add_argument("--config", action="append", default=[],
                   help="config file(s) (.json/.yaml), merged in order, "
                        "later wins (reference main-cfg/data-cfg precedence)")
    p.add_argument("--dataset", default="scannet",
                   choices=["scannet", "megadepth"])
    p.add_argument("--data-root", required=True)
    p.add_argument("--npz-path", default=None,
                   help="single npz (scannet test fixture)")
    p.add_argument("--npz-root", default=None,
                   help="directory of scene npzs (megadepth)")
    p.add_argument("--list-path", default=None)
    p.add_argument("--intrinsic-path", default=None)
    p.add_argument("--ckpt", default=None,
                   help="reference .ckpt, or the port's own checkpoint "
                        "(file or CheckpointManager directory)")
    p.add_argument("--thr", type=float, default=None,
                   help="override coarse matching threshold")
    p.add_argument("--pose-solver", default="opencv",
                   choices=["opencv", "native", "5pt", "batched",
                            "batched5pt"])
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--img-resize", type=int, default=840)
    p.add_argument("--max-matches", type=int, default=2048)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype: float32 = parity eval; bfloat16 = "
                        "deployment speed")
    p.add_argument("--config-json", default=None,
                   help="JSON dict of nested config overrides")
    p.add_argument("--dump", default=None, help="npz dump path for per-pair "
                   "results (visualization / offline analysis)")
    p.add_argument("--figures-dir", default=None,
                   help="save epi-error-colored match figures (PNG) for the "
                        "first --n-figures pairs")
    p.add_argument("--n-figures", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch path")
    return p.parse_args(argv)


def load_state(path: str):
    """A state_dict from a reference ``.ckpt`` or a port checkpoint."""
    import torch
    if path.endswith(".ckpt"):
        from loftr_tpu_torch.utils.weights import load_checkpoint_state
        return load_checkpoint_state(path)
    if os.path.isdir(path):
        from loftr_tpu_torch.train.checkpoint import CheckpointManager
        mgr = CheckpointManager(path)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = mgr.path(step)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return state["module"] if "module" in state else state


def build_model(args, cfg):
    from loftr_tpu_torch.models.matcher import LoFTR
    from loftr_tpu_torch.utils.weights import init_weights
    model = LoFTR(cfg.loftr)
    if args.ckpt:
        model.load_state_dict(load_state(args.ckpt))
    else:
        print("WARNING: no checkpoint given - random weights",
              file=sys.stderr)
        init_weights(model, seed=0)
    return model


def build_datasets(args, cfg):
    from loftr_tpu_torch.data import MegaDepthDataset, ScanNetDataset
    if args.dataset == "scannet":
        return [ScanNetDataset(
            args.data_root, args.npz_path, args.intrinsic_path, mode="test",
            min_overlap_score=cfg.dataset.min_overlap_score_test)]
    npzs = sorted(glob.glob(os.path.join(args.npz_root, "*.npz")))
    if args.list_path:
        with open(args.list_path) as f:
            wanted = {ln.strip() for ln in f if ln.strip()}
        npzs = [n for n in npzs
                if os.path.basename(n).split(".")[0] in wanted]
    return [MegaDepthDataset(
        args.data_root, n, mode="test", min_overlap_score=0.0,
        img_resize=args.img_resize, df=cfg.dataset.mgdpt_df,
        img_padding=True, depth_padding=False) for n in npzs]


def main(argv=None) -> dict:
    """Run the evaluation; prints and returns the aggregated metrics."""
    args = parse_args(argv)
    from loftr_tpu_torch.api import resolve_device
    from loftr_tpu_torch.config import get_config_from_files
    from loftr_tpu_torch.data import DataLoader
    from loftr_tpu_torch.data.sampler import ConcatDataset
    from loftr_tpu_torch.eval.evaluator import Evaluator

    device = resolve_device(args.device)
    overrides = {"loftr": {"dtype": args.dtype,
                           "match_coarse":
                           {"max_matches": args.max_matches}}}
    if args.thr is not None:
        overrides["loftr"]["match_coarse"]["thr"] = args.thr
    if args.dataset == "megadepth":
        overrides["trainer"] = {"epi_err_thr": 1e-4}
    cfg = get_config_from_files(
        *args.config, preset=args.preset, fallback="scannet_eval",
        overrides=overrides)
    if args.config_json:
        cfg = cfg.replaced(json.loads(args.config_json))

    datasets = build_datasets(args, cfg)
    ev = Evaluator(cfg, build_model(args, cfg), pose_solver=args.pose_solver,
                   device=device)
    loader = DataLoader(ConcatDataset(datasets), args.batch_size,
                        num_workers=args.num_workers, drop_last=False)
    figure_sink = None
    if args.figures_dir:
        os.makedirs(args.figures_dir, exist_ok=True)
        counter = {"i": 0}

        def figure_sink(figs):
            import matplotlib.pyplot as plt
            for fig in figs:
                fig.savefig(os.path.join(
                    args.figures_dir, f"pair_{counter['i']:04d}.png"),
                    bbox_inches="tight")
                plt.close(fig)
                counter["i"] += 1

    conf_thr = 1e-4 if args.dataset == "megadepth" else 5e-4
    agg = ev.evaluate_batches(loader, dump_path=args.dump,
                              figure_sink=figure_sink,
                              n_figure_pairs=args.n_figures,
                              figure_conf_thr=conf_thr)
    print(json.dumps(agg), flush=True)
    return agg


if __name__ == "__main__":
    main()
