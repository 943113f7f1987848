"""The numbers ``correct`` compares, for many seeds in one process: the
lower readings of the limits (``check.py``).

    python3 bench_port/readings.py --workload indoor_ds.match_b8 \
        --seeds 1 2 3 --seconds 2

Each seed is a whole run of the cell (set-up, a short window, the check)
with its timings dropped; one JSON line a seed.  A run of the benchmark
never runs this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_port import core  # noqa: E402
from bench_port.run import measure  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        core.say("readings.py needs a CUDA device")
        return 2
    cell = core.load_cell(args.workload)
    cell.workload["limits"] = {}   # every number printed as a reading
    for seed in args.seeds:
        out = measure(cell, seed, args.seconds, False,
                      torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "attempted": out.attempted, **out.readings}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
