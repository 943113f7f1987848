#!/usr/bin/env python3
"""Device-time breakdown of the PyTorch/CUDA port's flagship forward, or
of one training step.

    python3 tools/profile_torch_port.py [--ot] [--batch 1 8] [--iters 5]
    python3 tools/profile_torch_port.py [--ot] --train [--batch 2] [--iters 3]

Runs ``indoor_ds`` (with ``--ot``: ``indoor_ot``, the Sinkhorn matcher) bf16
at 640x480 (seeded random weights) under
``torch.profiler`` on one CUDA device and prints, per batch size, one JSON
line: wall ms per forward (with ``--train``: per ``Trainer.train_step`` on
a seeded batch), the summed device-kernel ms, the device idle share
(1 - kernel time / wall time; every kernel runs on one stream, so kernel
times do not overlap) and the kernels with the most device time.
Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=None,
                    help="batch sizes (default 1 8; with --train 2)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--train", action="store_true",
                    help="profile Trainer.train_step instead of the forward")
    ap.add_argument("--ot", action="store_true",
                    help="the indoor_ot preset instead of indoor_ds")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_port.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from loftr_tpu_torch.api import load_matcher, with_config
    from loftr_tpu_torch.structs import MatchInput

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    rng = np.random.RandomState(0)
    preset = "indoor_ot" if args.ot else "indoor_ds"
    if not args.train:
        model = with_config(load_matcher(preset=preset, seed=0),
                            {"dtype": "bfloat16"})
    for B in args.batch or ([2] if args.train else [1, 8]):
        if args.train:
            import chip_smoke
            from loftr_tpu_torch.train.trainer import Trainer
            trainer = Trainer(chip_smoke.train_config("bfloat16", B, preset),
                              batch_size_per_device=B)
            state = trainer.init_state(seed=0)
            batch = chip_smoke.train_batch(0, B).to("cuda")
            run = lambda: trainer.train_step(state, batch)
        else:
            img = torch.from_numpy(
                rng.rand(2, B, 480, 640, 1).astype(np.float32))
            inp = MatchInput(image0=img[0].cuda(), image1=img[1].cuda())
            run = lambda: model(inp)
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / args.iters
        by_name = {}
        for e in prof.events():       # device-side kernels only
            if e.device_type != DeviceType.CUDA:
                continue
            us = e.device_time_total
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + us, c + 1)
        total = sum(t for t, _ in by_name.values())
        rows = [(t, k, c) for k, (t, c) in by_name.items()]
        rows.sort(reverse=True)
        dev_ms = total / 1e3 / args.iters
        print(json.dumps({
            "device": smi, "what": "train_step" if args.train else "forward",
            "preset": preset, "batch": B, "wall_ms": wall,
            "device_kernel_ms": dev_ms,
            "device_idle_share": max(0.0, 1.0 - dev_ms / wall),
            "top": [{"kernel": k[:90], "ms": us / 1e3 / args.iters,
                     "calls": c // args.iters} for us, k, c in
                    rows[:args.top]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
