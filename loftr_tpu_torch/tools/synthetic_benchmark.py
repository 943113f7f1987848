"""In-image accuracy loop on the port: train on synthetic scenes -> run the
port's eval CLI (``python -m loftr_tpu_torch.test``) -> pose AUC.

The counterpart of the JAX package's ``tools/synthetic_benchmark.py``, with
its flags, defaults and printed artifact keys: geometrically exact
synthetic scenes (``data/synthetic.py``) in the MegaDepth layout, trained
through the port's data pipeline and ``Trainer``, then evaluated by the
port's eval CLI in a subprocess (matcher -> epipolar errors -> RANSAC pose
-> aggregate_metrics).  The subprocess runs on the same device as the
training (``--device``): a CUDA device can serve two processes.

Usage (on the card; ``--device cpu`` runs it on the CPU):
  python -m loftr_tpu_torch.tools.synthetic_benchmark \\
      --work-dir /tmp/synthbench --steps 400 --out build/synthetic_auc.json

Losses stay on the device during training and are read every
``log_every`` steps (the numbers are the JAX tool's, which reads one a
step).  ``--depth-format npy`` writes the depth maps as ``.npy`` (a host
without ``h5py``); figures need ``matplotlib`` and are skipped with a
warning where it is missing.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

# scaled-down but architecturally complete model (all 7 stages, BN backbone,
# dual-softmax, fine refinement), the JAX tool's; the fine stage takes the
# plain layer stack because the fine-stage kernel needs C % 64 == 0 and
# raises at this d_model of 32 (the JAX anchor runs took the plain stack
# too: float32 configs skip the Pallas kernels on the TPU)
SMALL_MODEL = {
    "loftr": {
        "dtype": "float32",
        "backbone": {"initial_dim": 32, "block_dims": (32, 48, 64)},
        "coarse": {"d_model": 64, "nhead": 4,
                   "layer_names": ("self", "cross") * 2},
        "fine": {"d_model": 32, "nhead": 2,
                 "layer_names": ("self", "cross"), "use_pallas": False},
        "match_coarse": {"train_matches": 96, "train_pad_num_gt_min": 12,
                         "max_matches": 192, "thr": 0.2,
                         "use_pallas": False},
    },
}


def generate_data(work_dir: str, n_train_scenes: int, n_test_scenes: int,
                  views: int, img_size: int, seed: int,
                  baseline: float = 0.6, depth_format: str = "h5"):
    from loftr_tpu_torch.data.synthetic import write_megadepth_scene

    train_npzs, test_npzs = [], []
    for s in range(n_train_scenes):
        train_npzs.append(write_megadepth_scene(
            work_dir, f"train_{s:04d}", seed=seed + 97 * s,
            n_views=views, img_size=img_size, baseline=baseline,
            depth_format=depth_format))
    # held-out scenes: different seeds -> unseen textures AND geometry
    for s in range(n_test_scenes):
        test_npzs.append(write_megadepth_scene(
            work_dir, f"test_{s:04d}", seed=seed + 10_007 + 131 * s,
            n_views=views, img_size=img_size, baseline=baseline,
            depth_format=depth_format))
    # the eval CLI globs --npz-root; keep held-out indices in their own dir
    test_idx = osp.join(work_dir, "index_test")
    os.makedirs(test_idx, exist_ok=True)
    for p in test_npzs:
        os.replace(p, osp.join(test_idx, osp.basename(p)))
    return train_npzs, test_idx


def train(work_dir: str, train_npzs, img_size: int, img_resize: int,
          steps: int, batch_size: int, lr: float, seed: int,
          log_every: int = 25, train_sampling: str = "per_pair",
          extra_overrides: dict | None = None,
          ckpt_name: str = "ckpt_params", device="cuda",
          init_seed: int | None = None):
    """Train the small model; ``init_seed`` (default ``seed``) seeds the
    initial weights and the selection draws apart from the data order."""
    import torch
    from loftr_tpu_torch.config import get_config
    from loftr_tpu_torch.data import DataLoader
    from loftr_tpu_torch.data.megadepth import MegaDepthDataset
    from loftr_tpu_torch.data.sampler import ConcatDataset
    from loftr_tpu_torch.train.checkpoint import save_params
    from loftr_tpu_torch.train.trainer import Trainer

    cfg = get_config("default", SMALL_MODEL).replaced({
        "loftr": {"match_coarse": {"train_sampling": train_sampling}},
        "trainer": {"canonical_bs": batch_size, "canonical_lr": lr,
                    "scheduler_interval": "step", "warmup_step": 50,
                    "scheduler": "CosineAnnealing", "cosa_tmax": steps,
                    "seed": seed}})
    if extra_overrides:
        cfg = cfg.replaced(extra_overrides)
    datasets = [MegaDepthDataset(
        work_dir, p, mode="train", min_overlap_score=0.0,
        img_resize=img_resize, df=8, img_padding=True, depth_padding=True,
        depth_max_size=img_size) for p in train_npzs]
    concat = ConcatDataset(datasets)
    print(f"train pairs: {len(concat)}")

    rng = np.random.RandomState(seed)
    trainer = Trainer(cfg, world_size=1, batch_size_per_device=batch_size,
                      device=device)
    state = trainer.init_state(seed if init_seed is None else init_seed)
    losses, pending = [], []
    t0 = time.time()
    step = 0
    while step < steps:
        order = rng.permutation(len(concat)).tolist()
        loader = DataLoader(concat, batch_size, sampler=order,
                            num_workers=4, drop_last=True)
        for inp, meta in loader:
            state, sc = trainer.train_step(state, inp)
            pending.append(sc["loss"])
            step += 1
            if step % log_every == 0 or step >= steps:
                losses += torch.stack(pending).float().cpu().tolist()
                pending = []
            if step % log_every == 0:
                print(f"step {step}/{steps} loss "
                      f"{np.mean(losses[-log_every:]):.4f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
            if step >= steps:
                break
    ckpt = osp.join(work_dir, ckpt_name)
    save_params(ckpt, state.module)
    return ckpt, losses


def figures_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def evaluate_cli(work_dir: str, test_idx: str, ckpt: str, img_resize: int,
                 pose_solver: str = "opencv", extra_env=None,
                 ransac_thr: float = 1.5,
                 extra_cfg: dict | None = None, device="cuda",
                 tf32: bool = False) -> dict:
    """Drive the port's eval CLI end to end in a subprocess.

    ransac_thr: 1.5 px (the JAX tool swept 0.5/1.0/1.5/2.0/3.0 -> 1.5
    maximizes AUC).  The reference's 0.5 px is tuned for 640/840 px images;
    at 256 px the fine stage's ~1-1.5 px match noise exceeds it and RANSAC
    fits minimal sub-populations.

    tf32: False (default) runs the child with ``NVIDIA_TF32_OVERRIDE=0``,
    so that its float32 model evaluates in float32 as the JAX tool's does;
    cuDNN's default TF32 convolutions move one checkpoint's auc@10 and
    auc@20 by 0.03-0.04.  True keeps PyTorch's defaults."""
    dump = osp.join(work_dir, "eval_dump.npz")
    cfg_json = dict(SMALL_MODEL)
    if extra_cfg:
        loftr = dict(cfg_json["loftr"])
        for k, v in extra_cfg.get("loftr", {}).items():
            if isinstance(v, dict) and isinstance(loftr.get(k), dict):
                loftr[k] = {**loftr[k], **v}
            else:
                loftr[k] = v
        cfg_json = {**extra_cfg, "loftr": loftr}
    cfg_json["trainer"] = {"ransac_pixel_thr": ransac_thr}
    cmd = [
        sys.executable, "-m", "loftr_tpu_torch.test",
        "--dataset", "megadepth",
        "--data-root", work_dir,
        "--npz-root", test_idx,
        "--img-resize", str(img_resize),
        "--ckpt", ckpt,
        "--pose-solver", pose_solver,
        "--dtype", "float32",
        "--preset", "default",
        "--config-json", json.dumps(cfg_json),
        "--dump", dump,
        "--device", str(device),
    ]
    if figures_available():
        cmd += ["--figures-dir", osp.join(work_dir, "figures"),
                "--n-figures", "4"]
    else:
        print("[synthetic_benchmark] matplotlib unavailable: no figures",
              file=sys.stderr)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    if not tf32:
        env["NVIDIA_TF32_OVERRIDE"] = "0"
    env.update(extra_env or {})
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=1200)
    if out.returncode != 0:
        raise RuntimeError(
            f"loftr_tpu_torch.test failed:\n{out.stdout}\n{out.stderr}")
    last = [ln for ln in out.stdout.strip().splitlines()
            if ln.startswith("{")][-1]
    return json.loads(last)


def save_untrained(work_dir: str) -> str:
    """The random-init control's checkpoint: the port's seeded init (seed
    123, the JAX tool's PRNGKey)."""
    from loftr_tpu_torch.config import get_config
    from loftr_tpu_torch.models.matcher import LoFTR
    from loftr_tpu_torch.train.checkpoint import save_params
    from loftr_tpu_torch.utils.weights import init_weights
    rnd = osp.join(work_dir, "ckpt_random")
    save_params(rnd, init_weights(LoFTR(get_config("default",
                                                   SMALL_MODEL).loftr), 123))
    return rnd


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m loftr_tpu_torch.tools.synthetic_benchmark",
        description=__doc__)
    ap.add_argument("--work-dir",
                    default=osp.join(tempfile.gettempdir(), "synthbench"))
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--img-resize", type=int, default=128)
    ap.add_argument("--train-scenes", type=int, default=4)
    ap.add_argument("--test-scenes", type=int, default=3)
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--ransac-thr", type=float, default=1.5)
    ap.add_argument("--train-sampling", default="per_pair",
                    choices=["per_pair", "global_replacement"],
                    help="predicted-slot sampling semantics "
                         "(ops/matching.py; tools/seed_sweep.py A/B)")
    ap.add_argument("--baseline", type=float, default=0.6,
                    help="mean per-step camera baseline in world units "
                         "(~depth 3.0); pose-from-E needs the epipolar "
                         "displacement f*b/z well above the ~1px match "
                         "noise floor")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pose-solver", default="opencv")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the training and of the eval "
                         "subprocess; cpu runs the plain PyTorch path")
    ap.add_argument("--depth-format", default="h5", choices=["h5", "npy"],
                    help="depth files of the synthetic scenes (npy: a host "
                         "without h5py)")
    ap.add_argument("--eval-untrained", action="store_true",
                    help="also evaluate the random-init model (control)")
    ap.add_argument("--out", default=None, help="artifact json path")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark; prints and returns the artifact."""
    args = parse_args(argv)
    from loftr_tpu_torch.api import resolve_device
    resolve_device(args.device)

    t0 = time.time()
    os.makedirs(args.work_dir, exist_ok=True)
    train_npzs, test_idx = generate_data(
        args.work_dir, args.train_scenes, args.test_scenes, args.views,
        args.img_size, args.seed, baseline=args.baseline,
        depth_format=args.depth_format)
    print(f"data generated in {time.time() - t0:.0f}s")

    ckpt, losses = train(args.work_dir, train_npzs, args.img_size,
                         args.img_resize, args.steps, args.batch, args.lr,
                         args.seed, train_sampling=args.train_sampling,
                         device=args.device)

    results = {}
    if args.eval_untrained:
        # random-weights control: proves the AUC comes from training
        rnd = save_untrained(args.work_dir)
        results["untrained"] = evaluate_cli(
            args.work_dir, test_idx, rnd, args.img_resize,
            args.pose_solver, ransac_thr=args.ransac_thr, device=args.device)
        print("untrained:", json.dumps(results["untrained"]))

    results["trained"] = evaluate_cli(
        args.work_dir, test_idx, ckpt, args.img_resize, args.pose_solver,
        ransac_thr=args.ransac_thr, device=args.device)
    print("trained:", json.dumps(results["trained"]))

    curve = [round(float(np.mean(losses[i:i + 20])), 4)
             for i in range(0, len(losses), 20)]
    artifact = {
        "config": {k: v for k, v in vars(args).items()
                   if k not in ("out", "work_dir")},
        "train_loss_first20": round(float(np.mean(losses[:20])), 4),
        "train_loss_last20": round(float(np.mean(losses[-20:])), 4),
        "train_loss_curve_per20": curve,
        "results": results,
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(artifact))
    if args.out:
        os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print("wrote", args.out)
    return artifact


if __name__ == "__main__":
    main()
