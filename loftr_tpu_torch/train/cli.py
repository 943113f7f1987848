"""Training entry point on the port: ``python -m loftr_tpu_torch.train``.

The counterpart of the JAX package's top-level ``train.py`` (the
reference's train.py): config preset + files + overrides, LR scaling by the
effective batch (train.py:70-77), scene-balanced sampling, the train loop
with checkpoints, a preemption checkpoint and per-epoch validation.

Usage:
  python -m loftr_tpu_torch.train --preset outdoor_ds --dataset megadepth \\
      --data-root data/megadepth/train \\
      --npz-root data/megadepth/index/scene_info_0.1_0.7 \\
      --list-path data/megadepth/index/trainvaltest_list/train_list.txt \\
      --val-npz-path data/megadepth/index/scene_info_val/0015.npz \\
      --batch-size 1 --max-epochs 30 [--device cuda]

It runs on the CUDA device; ``--device cpu`` runs the plain PyTorch path on
the CPU (without it, a host with no CUDA device raises).  ``main(argv)``
runs in-process and returns the final ``TrainState``.

The loop keeps the JAX package's semantics:
  - ``--steps-per-epoch`` sets the epoch length of the LR schedule
    (epoch-interval schedules), not the loop's: an epoch of the loop is one
    pass over the sampler;
  - after ``--resume`` the epoch loop starts again at 0 (and the sampler at
    its first draw), with the step, optimizer, selection generator and
    schedule position carried on from the checkpoint;
  - validation runs once an epoch through one ``Evaluator``, built at the
    first validation with the training module itself; the checkpoint
    manager keeps the best ``auc@10`` checkpoints.
Losses and the other step scalars stay on the device; the logger reads them
(one synchronisation) only at ``--log-every`` steps.  Left out, as TPU/JAX
only: the platform-env helper, ``jax.distributed`` and the interleave
packing under several devices.  Several processes raise in ``Trainer``
(data parallelism waits for the parallel modules, ``ROADMAP.md``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import signal
import sys

import torch

from loftr_tpu_torch.api import resolve_device
from loftr_tpu_torch.config import get_config_from_files
from loftr_tpu_torch.data import (DataLoader, MegaDepthDataset,
                                  ScanNetDataset, SceneBalancedSampler,
                                  get_local_split)
from loftr_tpu_torch.data.augment import build_augmentor
from loftr_tpu_torch.data.sampler import ConcatDataset
from loftr_tpu_torch.eval.evaluator import DEVICE_SOLVERS, HOST_SOLVERS
from loftr_tpu_torch.utils.logging import MetricsLogger, process_rank


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m loftr_tpu_torch.train",
                                description=__doc__)
    p.add_argument("--preset", default=None,
                   help="named preset (default indoor_ds; config files may also set preset:)")
    p.add_argument("--config", action="append", default=[],
                   help="config file(s) (.json/.yaml), merged in order, later wins (reference main-cfg/data-cfg precedence)")
    p.add_argument("--dataset", default="scannet",
                   choices=["scannet", "megadepth"])
    p.add_argument("--data-root", required=True)
    p.add_argument("--npz-root", required=True)
    p.add_argument("--list-path", required=True)
    p.add_argument("--intrinsic-path", default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--max-epochs", type=int, default=30)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--ckpt-dir", default="logs/ckpt")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=66)
    p.add_argument("--accum-steps", type=int, default=1,
                   help="gradient accumulation micro-steps per optimizer "
                        "update (recovers the canonical bs=64 recipe on "
                        "small slices; LR scaling counts the effective "
                        "batch)")
    p.add_argument("--img-resize", type=int, default=840)
    p.add_argument("--steps-per-epoch", type=int, default=0,
                   help="override; default = n_scenes*n_samples/bs")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--tensorboard", action="store_true",
                   help="mirror scalars/figures into TensorBoard event "
                        "files under <ckpt-dir>/logs/tb")
    p.add_argument("--n-samples-per-subset", type=int, default=0,
                   help="override TRAINER.N_SAMPLES_PER_SUBSET")
    p.add_argument("--config-json", default=None,
                   help="JSON dict of nested config overrides")
    p.add_argument("--val-npz-path", default=None,
                   help="val npz (enables per-epoch val)")
    p.add_argument("--val-dataset", default=None,
                   choices=["scannet", "megadepth"],
                   help="val dataset family (default: same as --dataset)")
    p.add_argument("--val-data-root", default=None)
    p.add_argument("--val-dump", action="store_true",
                   help="save per-pair val records (render with "
                        "tools/visualize_dump.py) - the reference's "
                        "TensorBoard match-figure logging equivalent")
    p.add_argument("--val-pose-solver", default="batched",
                   choices=list(DEVICE_SOLVERS + HOST_SOLVERS),
                   help="batched: RANSAC on the device (the JAX package's "
                        "'jax'); opencv, native, 5pt: on the host")
    p.add_argument("--val-figures", type=int, default=8,
                   help="log match figures for the first N val pairs each "
                        "val epoch (PNG under <ckpt-dir>/logs/figures, "
                        "mirrored to TB with --tensorboard; 0 disables) - "
                        "the reference's n_val_pairs_to_plot "
                        "(lightning_loftr.py:194-198)")
    p.add_argument("--val-figures-every", type=int, default=1,
                   help="log val figures every N epochs")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the plain PyTorch path")
    return p.parse_args(argv)


def build_datasets(args, cfg, world_size, rank):
    # dataset.augmentation_type -> working DarkAug/MobileAug (the reference
    # declares but disables these, src/utils/augment.py:41-51)
    augment_fn = build_augmentor(cfg.dataset.augmentation_type)

    with open(args.list_path) as f:
        scenes = [ln.strip() for ln in f if ln.strip()]
    local = get_local_split(scenes, world_size, rank, cfg.trainer.seed)
    datasets = []
    for scene in local:
        npz = os.path.join(args.npz_root, f"{scene}.npz")
        if args.dataset == "scannet":
            datasets.append(ScanNetDataset(
                args.data_root, npz, args.intrinsic_path, mode="train",
                min_overlap_score=cfg.dataset.min_overlap_score_train,
                augment_fn=augment_fn))
        else:
            datasets.append(MegaDepthDataset(
                args.data_root, npz, mode="train",
                min_overlap_score=cfg.dataset.min_overlap_score_train,
                img_resize=args.img_resize, df=cfg.dataset.mgdpt_df,
                img_padding=True, depth_padding=True,
                augment_fn=augment_fn))
    return ConcatDataset(datasets)


def build_val_dataset(args, cfg):
    """Validation dataset (ScanNet or MegaDepth), built once.

    The reference validates on either dataset family
    (src/lightning/data.py:106-156); --val-dataset defaults to the train
    dataset family.
    """
    kind = args.val_dataset or args.dataset
    root = args.val_data_root or args.data_root
    if kind == "scannet":
        return ScanNetDataset(root, args.val_npz_path, args.intrinsic_path,
                              mode="test")
    return MegaDepthDataset(
        root, args.val_npz_path, mode="test",
        min_overlap_score=0.0, img_resize=args.img_resize,
        df=cfg.dataset.mgdpt_df, img_padding=True, depth_padding=True)


def build_sampler(args, cfg, dataset, rank):
    n_samples = args.n_samples_per_subset or cfg.trainer.n_samples_per_subset
    return SceneBalancedSampler(
        dataset, n_samples, cfg.trainer.sb_subset_sample_replacement,
        cfg.trainer.sb_subset_shuffle, cfg.trainer.sb_repeat,
        seed=cfg.trainer.seed + rank)


def trainer_config(args, cfg, sampler):
    """The config the Trainer is built from: steps_per_epoch counts
    OPTIMIZER updates (epoch-interval schedules key off it); with
    accumulation an epoch has micro_steps/accum real updates."""
    steps_per_epoch = args.steps_per_epoch or max(
        1, len(sampler) // args.batch_size // max(1, args.accum_steps))
    return cfg.replaced({"trainer": {"steps_per_epoch": steps_per_epoch,
                                     "seed": args.seed,
                                     "accum_steps": args.accum_steps}})


def main(argv=None):
    args = parse_args(argv)
    from loftr_tpu_torch.eval.evaluator import Evaluator
    from loftr_tpu_torch.train.checkpoint import CheckpointManager
    from loftr_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    dist = torch.distributed
    world_size = (dist.get_world_size()
                  if dist.is_available() and dist.is_initialized() else 1)
    rank = process_rank()

    cfg = get_config_from_files(
        *args.config, preset=args.preset, fallback="indoor_ds",
        overrides=json.loads(args.config_json) if args.config_json else None)
    dataset = build_datasets(args, cfg, world_size, rank)
    sampler = build_sampler(args, cfg, dataset, rank)
    cfg = trainer_config(args, cfg, sampler)

    trainer = Trainer(cfg, world_size=world_size,
                      batch_size_per_device=args.batch_size, device=device)
    mgr = CheckpointManager(os.path.abspath(args.ckpt_dir))
    logger = MetricsLogger(log_dir=os.path.join(args.ckpt_dir, "logs"),
                           tensorboard=args.tensorboard)
    if args.val_figures > 0 and importlib.util.find_spec(
            "matplotlib") is None:
        print("[logging] matplotlib unavailable: no val figures",
              file=sys.stderr)
        args.val_figures = 0

    # preemption-safe checkpointing (SURVEY.md §5.3): on SIGTERM/SIGINT save
    # the current state at the next step boundary so --resume continues
    preempted = {"flag": False}

    def _on_signal(signum, frame):
        preempted["flag"] = True
        print(f"signal {signum}: checkpoint at next step boundary",
              flush=True)

    previous = {s: signal.signal(s, _on_signal)
                for s in (signal.SIGTERM, signal.SIGINT)}
    loader = DataLoader(dataset, args.batch_size, sampler,
                        num_workers=args.num_workers)
    # JAX's loop reads one batch before training (its example for the
    # parameter init), which draws one epoch of the sampler; the same draw
    # here keeps the port's epochs on JAX's sample order
    iter(sampler)

    # val dataset + Evaluator built ONCE: the evaluator holds the training
    # module, so it sees the current parameters at every epoch
    val_ds = build_val_dataset(args, cfg) if args.val_npz_path else None
    evaluator = None
    state = trainer.init_state(cfg.trainer.seed)
    try:
        if args.resume and mgr.latest_step() is not None:
            state = mgr.restore(state)
            print(f"resumed from step {state.step}", flush=True)

        for epoch in range(args.max_epochs):
            for inp, meta in loader:
                state, scalars = trainer.train_step(state, inp)
                if state.step % args.log_every == 0:
                    logger.log(state.step, scalars, epoch=epoch)
                if preempted["flag"]:
                    if rank == 0:
                        mgr.save(state.step, state)
                        print("preemption checkpoint saved; exiting",
                              flush=True)
                    return state
            metrics = {}
            if val_ds is not None:
                if evaluator is None:
                    evaluator = Evaluator(cfg, state.module,
                                          pose_solver=args.val_pose_solver,
                                          device=device)
                # rank-0 match figures every N val epochs (reference:
                # lightning_loftr.py:194-198 -> logger figure logging)
                figure_sink = None
                if (rank == 0 and args.val_figures > 0
                        and epoch % max(1, args.val_figures_every) == 0):
                    figure_sink = (lambda figs, _s=state.step:
                                   logger.log_figures(_s, figs, prefix="val"))
                metrics = evaluator.evaluate_dataset(
                    val_ds, batch_size=args.batch_size,
                    num_workers=args.num_workers,
                    world_size=world_size, rank=rank,
                    dump_path=(os.path.join(
                        args.ckpt_dir, "logs", f"val_dump_e{epoch}_r{rank}.npz")
                        if args.val_dump else None),
                    figure_sink=figure_sink,
                    n_figure_pairs=args.val_figures)
                logger.log(state.step, metrics, epoch=epoch, phase="val")
            if rank == 0:
                # ModelCheckpoint(monitor='auc@10') equivalent
                mgr.save(state.step, state, metrics=metrics or None)
        return state
    finally:
        logger.close()
        for s, handler in previous.items():
            signal.signal(s, handler)
