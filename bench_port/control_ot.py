"""Readings for the limits of ``correct`` in the OT cells: the control and
the planted faults, at a cell's own size, one line a seed.

    python3 bench_port/control_ot.py --workload outdoor_ot.match_ot_b4 \
        --seeds 11 12 13

The control is the Sinkhorn reference put in the port's place and computed
one precision below the configuration's bfloat16: every convolution and
matrix product, the similarity product included, in float8-e4m3
(``reference/loftr_ot_plain.py``, ``quant="fp8"``).  Faults of the
matching layer are planted in the float32 reference put in the port's
place (``faults``): one Sinkhorn iteration dropped (``iters_2``) and the
dustbin row and column left out (``no_dustbin``).  ``program`` is the
port's own answer over a short window, judged as it is and with some of
its matches moved in image 1 (``moved``, as ``MOVES`` says: a coarse
answer partly wrong, its keypoints moved with their cells and its
confidences kept).  ``program_iters_2`` is the port itself run with
``skh_iters`` 2 through the cell's generator, judged against the
reference at 3.  Everything goes through the cell's own comparison on the
pairs of the batches a run judges.  A run of the benchmark never runs
this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_port import check, core  # noqa: E402
from bench_port.data.pairs import make_pairs  # noqa: E402
from bench_port.generators.offline_ot import (OfflineOT,  # noqa: E402
                                               judged_pairs, ot_state)
from bench_port.reference.loftr_ot_plain import (PlainOT,  # noqa: E402
                                                 match_pair_ot, ref_pair_ot)
from bench_port.reference.loftr_plain import strict_float32  # noqa: E402
from bench_port.weights import make_state  # noqa: E402

FAULTS = {"iters_2": dict(iters=2), "no_dustbin": dict(dustbin=False)}
# which of the port's matches are moved, and where to: every ``every``-th
# match of each pair (the first of each pair among them), or every match of
# the first ``pairs`` judged pairs; to the nearest legal grid neighbour of
# its cell in image 1 or to a legal cell drawn from the seed
MOVES = {"neighbour_1pct": dict(every=100, to="neighbour"),
         "random_1pct": dict(every=100, to="random"),
         "neighbour_one_pair": dict(pairs=1, to="neighbour")}


def moved(ref: dict, ans: tuple, picked, to: str, rng) -> tuple:
    """``ans`` (i, j, mconf, keypoints 0, keypoints 1) with the matches
    ``picked`` (bool [M]) moved to another legal cell of image 1, as
    ``to`` says; their keypoints in image 1 move with their cells, so
    only the coarse answer is wrong."""
    i, j, mconf, k0, k1 = ans
    j, k1 = j.copy(), k1.copy()
    h1, w1 = ref["hw1"]
    ok1 = ref["ok1"].cpu().numpy().reshape(-1)
    legal = np.flatnonzero(ok1)
    for m in np.flatnonzero(picked):
        t = None
        if to == "neighbour":
            for d in (1, -1, w1, -w1):
                c = j[m] + d
                row = abs(d) != 1 or c // w1 == j[m] // w1
                if 0 <= c < h1 * w1 and row and ok1[c]:
                    t = c
                    break
        else:
            t = rng.choice(legal[legal != j[m]])
        if t is None:
            continue
        k1[m] += 8.0 * np.array([t % w1 - j[m] % w1, t // w1 - j[m] // w1])
        j[m] = t
    return i, j, mconf, k0, k1


def judge_moved(drv) -> dict:
    """The judged batches of generator ``drv`` (its window done, the
    program freed): the port's answer as it is and with its matches moved
    as each of ``MOVES`` says, each against the reference."""
    rng = np.random.default_rng(drv.seed)
    sound, per = [], {name: [] for name in MOVES}
    for k, (ref, ans) in enumerate(judged_pairs(drv, drv.judged())):
        sound.append(check.judge_pair(ref, *ans))
        M = len(ans[0])
        for name, mv in MOVES.items():
            if "pairs" in mv:
                picked = np.full(M, k < mv["pairs"])
            else:
                picked = np.arange(M) % mv["every"] == 0
            per[name].append(check.judge_pair(
                ref, *moved(ref, ans, picked, mv["to"], rng)))
        del ref
    return {"program": check.summarize_matches(sound),
            "moved": {name: check.summarize_matches(v)
                      for name, v in per.items()}}


def answer(model: PlainOT, feats, img0, img1, mask0, mask1, cfg: dict):
    """``model``'s answer for one pair as the port gives it, from the
    coarse and fine features and masks ``feats`` (``Plain.features``):
    (i, j, mconf, keypoints 0, keypoints 1) of its valid matches."""
    import torch
    c0, c1, f0, f1, mm0, mm1 = feats
    hw0 = (img0.shape[0] // 8, img0.shape[1] // 8)
    hw1 = (img1.shape[0] // 8, img1.shape[1] // 8)
    with torch.no_grad():
        conf, _, i, j, v = match_pair_ot(
            model, c0[0], c1[0], None if mm0 is None else mm0[0],
            None if mm1 is None else mm1[0], hw0, hw1, cfg["thr"],
            cfg["border_rm"], cfg["max_matches"], mask0=mask0, mask1=mask1)
        del conf
        e = model.fine(c0[0], c1[0], f0[0], f1[0], i, j, hw0, hw1)
        p0 = torch.stack([i % hw0[1], i // hw0[1]], -1).float() * 8
        p1 = torch.stack([j % hw1[1], j // hw1[1]], -1).float() * 8
        k1 = p1 + e[:, :2] * 4
    return (i.cpu().numpy(), j.cpu().numpy(), v.cpu().numpy(),
            p0.cpu().numpy(), k1.cpu().numpy())


def match_control_ot(cell, seed: int, dev) -> dict:
    """The control of an OT cell and the matching layer's planted faults,
    on the pairs of its first ``check_batches`` batches."""
    import torch
    mix, cfg = cell.mix, cell.config
    views, pad, n = mix["views"], mix["pad"], mix["pairs"]
    judged = range(mix["check_batches"] * mix["batch"])
    state = ot_state(make_state(cfg["widths"], seed, dev), cfg)
    P = make_pairs(seed, n, views, pad, dev)
    masked = any((v[0], v[1]) != tuple(pad) or (v[2], v[3]) != tuple(pad)
                 for v in views)
    strict_float32()
    inf, w = cfg["inference"], cfg["widths"]
    iters = inf["skh_iters"]
    ref_model = PlainOT(state, w, iters=iters)
    ctl_model = PlainOT(state, w, quant="fp8", iters=iters)
    faulty = {f: PlainOT(state, w, **{"iters": iters, **kw})
              for f, kw in FAULTS.items()}
    per_pair, faults = [], {f: [] for f in FAULTS}
    for p in judged:
        args = (P.image0[p].float() / 255.0, P.image1[p].float() / 255.0,
                P.mask0[p] if masked else None,
                P.mask1[p] if masked else None)
        ref = ref_pair_ot(ref_model, *args, inf)
        flat = lambda m: None if m is None else m.reshape(1, -1)
        with torch.no_grad():
            feats = ctl_model.features(args[0][None], args[1][None],
                                       *(None if m is None else m[None]
                                         for m in args[2:]))
        per_pair.append(check.judge_pair(
            ref, *answer(ctl_model, feats, *args, inf)))
        feats = (ref["c0"][None], ref["c1"][None], ref["f0"][None],
                 ref["f1"][None], flat(args[2]), flat(args[3]))
        for f, model in faulty.items():
            ans = answer(model, feats, *args, inf)
            faults[f].append(check.judge_pair(ref, *ans))
        del ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"control": check.summarize_matches(per_pair),
            "faults": {f: check.summarize_matches(v)
                       for f, v in faults.items()}}


def _program(cell, seed: int, dev, iters: int, seconds: float):
    """The cell's generator run for a short window with ``skh_iters =
    iters``, the program freed."""
    import torch
    drv = OfflineOT(cell, seed, dev)
    drv.program_inference["skh_iters"] = iters
    drv.setup()
    drv.window(seconds)
    drv.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return drv


def program_readings(cell, seed: int, dev, seconds: float = 2.0) -> dict:
    """The sound port over a short window, judged as it is and with its
    matches moved (``judge_moved``)."""
    inf = cell.config["inference"]
    return judge_moved(_program(cell, seed, dev, inf["skh_iters"], seconds))


def program_fault(cell, seed: int, dev, iters: int = 2,
                  seconds: float = 2.0) -> dict:
    """The port run with ``skh_iters = iters`` through the cell's
    generator for a short window, judged against the reference at the
    configuration's iterations."""
    return _program(cell, seed, dev, iters, seconds).check()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        core.say("control_ot.py needs a CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    cell = core.load_cell(args.workload)
    for seed in args.seeds:
        rec = match_control_ot(cell, seed, dev)
        rec.update(program_readings(cell, seed, dev))
        rec["program_iters_2"] = program_fault(cell, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "card": core.power_limit(), **rec}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
