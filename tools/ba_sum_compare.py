#!/usr/bin/env python3
"""Compare the ways bundle adjustment can sum its rows by camera (and by
camera pair) on one CUDA card: run-to-run bit equality, ms per LM
iteration and peak memory, at the keyframe scale of ``chip_smoke.py``
phase 13.

    python3 tools/ba_sum_compare.py [--C 300] [--P 100000] [--O 8]
                                    [--loops 3] [--device cuda] [--out FILE]

The sums (each a ``BAPlan``-like object with ``by_cam`` and ``by_pair``):

- ``segment``: the port's ``sfm.bundle_adjustment.BAPlan`` (``SegmentSum``:
  rows sorted by key once, then level by level gathered into a padded
  [runs, 32] table, the pad slots zeroed in place, and summed over the
  table's rows);
- ``tables``: the same, with a zero row appended to each level's input for
  the pad slots to read (a copy of the input: the port's first design);
- ``runs``: the same sort and runs, each level summed by ``embedding_bag``
  over runs of consecutive sorted rows (no gathered copy; other rounding);
- ``index_put``: ``Tensor.index_put_(..., accumulate=True)`` into zeros,
  which on CUDA sorts the keys on every call and sums each key's rows in
  sorted order (on a CPU with several threads it adds with atomics);
- ``index_add``: ``Tensor.index_add_``, atomics on CUDA.

For each sum and solver (``dense``, ``pcg``) on ``chip_smoke.long_ba_problem``
(noise 1e-3): one ``ba_iteration``'s ms (CUDA events, host included) and
device ms (profiler), launches, peak memory above the inputs; its largest
gap to the ``segment`` step; ``--loops`` full ``bundle_adjust`` runs
(``max_iters=25``), whether they give equal bits and their final costs; and
each sum alone at the step's shapes (``by_pair`` of the [P*O*O, 6, 6] pair
blocks, ``by_cam`` of a CG step's [P*O, 6] rows).  ``bundle_adjust`` builds
its sums through the module's ``BAPlan``, which this script swaps for the
sum under test.  The timed steps run in the order segment, tables, runs,
index_put, index_add, then again in reverse.  Prints one JSON object per (sum,
solver) and per sum alone, with the card's name and power limit; exits 2
without CUDA.  ``--device cpu`` (small sizes) reads the CPU's bit equality:
its ``ms`` are host times and its memory and launches null.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scatter_plan(kind):
    """A ``BAPlan`` stand-in summing by ``index_put_`` or ``index_add_``."""

    def sum_by(index, n):
        def f(rows):
            out = rows.new_zeros((n,) + rows.shape[1:])
            if kind == "index_put":
                return out.index_put_((index,), rows, accumulate=True)
            return out.index_add_(0, index, rows)
        return f

    class Plan:
        def __init__(self, obs_cam, n_cams, pairs=True):
            cam = obs_cam.reshape(-1)
            self.by_cam = sum_by(cam, n_cams)
            self.by_pair = None
            if pairs:
                pair = (obs_cam[:, :, None] * n_cams
                        + obs_cam[:, None, :]).reshape(-1)
                self.by_pair = sum_by(pair, n_cams * n_cams)
    return Plan


class _TableSum:
    """The first design of ``SegmentSum``: each level gathers runs of up to
    ``chunk`` rows of one key into a padded [runs, chunk] table (the pad
    reads a zero row appended to the level's input) and sums each run."""

    def __init__(self, keys, n_keys, chunk=32):
        import torch
        keys = keys.reshape(-1).long()
        self.n_keys = n_keys
        self.tables = []
        order = torch.argsort(keys, stable=True)
        k = keys[order]
        src = order
        while True:
            n = k.numel()
            counts = torch.bincount(k, minlength=n_keys)
            first = torch.cumsum(counts, 0) - counts
            pos = torch.arange(n, device=k.device) - first[k]
            runs = (counts + chunk - 1) // chunk
            run_first = torch.cumsum(runs, 0) - runs
            n_runs = int(runs.sum())
            if n_runs == n:
                break
            table = torch.full((n_runs * chunk,), n, dtype=torch.long,
                               device=k.device)
            table[(run_first[k] + pos // chunk) * chunk + pos % chunk] = src
            self.tables.append(table.reshape(n_runs, chunk))
            k = torch.repeat_interleave(
                torch.arange(n_keys, device=k.device), runs)
            src = torch.arange(n_runs, device=k.device)
        self.src = src
        self.keys = k

    def __call__(self, rows):
        import torch
        x = rows.reshape(rows.shape[0], math.prod(rows.shape[1:]))
        for table in self.tables:
            x = torch.cat([x, x.new_zeros((1, x.shape[1]))])[table].sum(1)
        out = x.new_zeros((self.n_keys, x.shape[1]))
        out[self.keys] = x[self.src]
        return out.reshape((self.n_keys,) + rows.shape[1:])


class _RunSum:
    """Sums by key through the same sort and runs as ``_TableSum``, each
    level summed by ``embedding_bag`` over runs of consecutive sorted rows
    (each bag added in order, no gathered copy)."""

    def __init__(self, keys, n_keys, chunk=32):
        import torch
        keys = keys.reshape(-1).long()
        self.n_keys = n_keys
        self.levels = []
        src = torch.argsort(keys, stable=True)
        k = keys[src]
        while True:
            counts = torch.bincount(k, minlength=n_keys)
            first = torch.cumsum(counts, 0) - counts
            pos = torch.arange(k.numel(), device=k.device) - first[k]
            starts = torch.nonzero(pos % chunk == 0)[:, 0]
            if starts.numel() == k.numel():
                break
            self.levels.append((src, starts))
            k = k[starts]
            src = torch.arange(starts.numel(), device=k.device)
        self.src, self.keys = src, k

    def __call__(self, rows):
        import torch.nn.functional as F
        x = rows.reshape(rows.shape[0], math.prod(rows.shape[1:]))
        for src, starts in self.levels:
            x = F.embedding_bag(src, x, starts, mode="sum")
        out = x.new_zeros((self.n_keys, x.shape[1]))
        out[self.keys] = x[self.src]
        return out.reshape((self.n_keys,) + rows.shape[1:])


def _sum_plan(Sum):
    """A ``BAPlan`` stand-in summing by camera and camera pair with Sum."""

    class Plan:
        def __init__(self, obs_cam, n_cams, pairs=True):
            self.by_cam = Sum(obs_cam, n_cams)
            self.by_pair = None
            if pairs:
                self.by_pair = Sum(
                    obs_cam[:, :, None] * n_cams + obs_cam[:, None, :],
                    n_cams * n_cams)
    return Plan


def _host_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1000 * (time.perf_counter() - t0) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--C", type=int, default=300)
    ap.add_argument("--P", type=int, default=100_000)
    ap.add_argument("--O", type=int, default=8)
    ap.add_argument("--loops", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    on_cpu = args.device == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        print("ba_sum_compare.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import (_ba_problem, _equal_bits, _rel, cuda_ms,
                            device_ms, kernel_launches, long_ba_problem)
    from loftr_tpu_torch.sfm import bundle_adjustment as ba

    smi = "cpu" if on_cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    if on_cpu:
        cuda_ms = _host_ms
        device_ms = kernel_launches = lambda fn, iters=None: None
        torch.cuda.synchronize = lambda: None
        torch.cuda.reset_peak_memory_stats = lambda: None
        torch.cuda.memory_allocated = torch.cuda.max_memory_allocated = (
            lambda: 0)
    log = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps({"nvidia_smi": smi, **rec})
        print(line, flush=True)
        if log is not None:
            log.write(line + "\n")

    torch.set_grad_enabled(False)
    dev = torch.device("cpu") if on_cpu else torch.device("cuda", 0)
    C, P, O = args.C, args.P, args.O
    arrays, _, _ = long_ba_problem(C, P, O, 1e-3, pose_noise=0.01,
                                   point_noise=0.03, seed=0)
    prob = _ba_problem(arrays, dev)
    plans = {"segment": ba.BAPlan, "tables": _sum_plan(_TableSum),
             "runs": _sum_plan(_RunSum),
             "index_put": _scatter_plan("index_put"),
             "index_add": _scatter_plan("index_add")}
    seg_plan = ba.BAPlan
    lam = 1e-4

    # each sum alone at the step's shapes
    g = torch.Generator(device=dev).manual_seed(0)
    blocks = torch.randn(P * O * O, 6, 6, device=dev, generator=g)
    rows = torch.randn(P * O, 6, device=dev, generator=g)
    for name, Plan in plans.items():
        plan = Plan(prob.obs_cam, C, pairs=True)
        rec = {"sum": name, "alone": True}
        for key, fn in (("by_pair_36", lambda: plan.by_pair(blocks)),
                        ("by_cam_6", lambda: plan.by_cam(rows))):
            first = fn()
            rec[key + "_ms"] = cuda_ms(fn, iters=10, warmup=2)
            rec[key + "_equal_bits_x5"] = all(
                torch.equal(first, fn()) for _ in range(5))
        emit(rec)
    del blocks, rows

    steps, results = {}, {}
    for solver in ("dense", "pcg"):
        for name, Plan in plans.items():
            plan = Plan(prob.obs_cam, C, pairs=solver == "dense")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            first = ba.ba_iteration(prob, lam, solver=solver, plan=plan)
            torch.cuda.synchronize()
            peak = None if on_cpu else (
                torch.cuda.max_memory_allocated() - base) / 2**20
            again = [ba.ba_iteration(prob, lam, solver=solver, plan=plan)
                     for _ in range(4)]
            steps[name, solver] = (plan, first)
            results[name, solver] = {
                "sum": name, "solver": solver, "C": C, "P": P, "O": O,
                "peak_mem_MiB": peak,
                "step_equal_bits_x5": all(
                    _equal_bits(first[0], a[0]) and torch.equal(first[2], a[2])
                    for a in again),
                "new_cost": float(first[2]), "ms": [], "device_ms": None}
    for solver in ("dense", "pcg"):
        order = list(plans) + list(plans)[::-1]
        for name in order:
            plan = steps[name, solver][0]
            results[name, solver]["ms"].append(cuda_ms(
                lambda: ba.ba_iteration(prob, lam, solver=solver, plan=plan),
                iters=5, warmup=1))
        for name in plans:
            plan = steps[name, solver][0]

            def step():
                return ba.ba_iteration(prob, lam, solver=solver, plan=plan)
            dms = device_ms(step, iters=3)
            rec = results[name, solver]
            rec["device_ms"] = None if dms is None else dms["total"]
            rec["launches"] = kernel_launches(step)
            ref = steps["segment", solver][1][0]
            rec["step_gap_to_segment"] = {
                k: _rel(getattr(steps[name, solver][1][0], k),
                        getattr(ref, k)) for k in ("R", "t", "points")}
            runs = []
            ba.BAPlan = plans[name]
            try:
                for _ in range(args.loops):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out, cost = ba.bundle_adjust(prob, max_iters=25,
                                                 solver=solver)
                    torch.cuda.synchronize()
                    runs.append((out, cost, time.perf_counter() - t0))
            finally:
                ba.BAPlan = seg_plan
            rec["loop_s"] = [r[2] for r in runs]
            rec["final_costs"] = [r[1] for r in runs]
            rec["loops_equal_bits"] = all(
                _equal_bits(runs[0][0], r[0]) and runs[0][1] == r[1]
                for r in runs[1:])
            emit(rec)
    if log is not None:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
