"""Readings for the limits of ``correct``: the control and the planted
faults, at a cell's own size, one line a seed.

    python3 bench_port/control.py --workload indoor_ds.match_b8 \
        --seeds 11 12 13

The control is the plain reference put in the port's place and computed
one precision below the configuration's bfloat16: every convolution and
matrix product in float8-e4m3 (``reference/loftr_plain.py``,
``quant="fp8"``).  Its outputs go through the same comparison as the
port's.  A matching cell's control matches the pairs of the batches a
run judges; the training cell's control takes the three
reference steps in fp8, and the cell's planted fault is read beside it:
the port's own first steps on half of each batch (the mean over the rest).
A matching cell's record also reads faults of the fine stage, planted in
the float32 reference put in the port's place: the refined offsets zeroed,
each match given the next match's offsets (the wrong window), and the fine
transformer skipped.  A run of the benchmark never runs this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_port import check, core  # noqa: E402
from bench_port.data.pairs import make_pairs  # noqa: E402
from bench_port.reference.loftr_plain import (Plain, match_pair,  # noqa
                                              strict_float32)
from bench_port.weights import make_state  # noqa: E402


FINE_FAULTS = ("zero_offsets", "swapped_windows", "fine_transformer_skipped")


class NoFineTransformer(Plain):
    """The reference with its fine transformer skipped."""

    def stack(self, prefix, names, f0, f1, m0=None, m1=None):
        if prefix == "loftr_fine":
            return f0, f1
        return super().stack(prefix, names, f0, f1, m0, m1)


def control_matches(model: Plain, img0, img1, mask0, mask1, cfg: dict,
                    fault: str = None):
    """The control's answer for one pair, as the port gives it: (i, j,
    mconf, keypoints 0, keypoints 1) of its valid matches; ``fault``
    alters the refined offsets as ``FINE_FAULTS`` names."""
    import torch
    m0 = None if mask0 is None else mask0[None]
    m1 = None if mask1 is None else mask1[None]
    with torch.no_grad():
        c0, c1, f0, f1, mm0, mm1 = model.features(img0[None], img1[None],
                                                  m0, m1)
        hw0 = (img0.shape[0] // 8, img0.shape[1] // 8)
        hw1 = (img1.shape[0] // 8, img1.shape[1] // 8)
        _, _, i, j, v = match_pair(
            model, c0[0], c1[0], None if mm0 is None else mm0[0],
            None if mm1 is None else mm1[0], hw0, hw1, cfg["thr"],
            cfg["border_rm"], cfg["max_matches"], mask0=mask0, mask1=mask1)
        e = model.fine(c0[0], c1[0], f0[0], f1[0], i, j, hw0, hw1)
        p0 = torch.stack([i % hw0[1], i // hw0[1]], -1).float() * 8
        p1 = torch.stack([j % hw1[1], j // hw1[1]], -1).float() * 8
        off = e[:, :2] * 4
        if fault == "zero_offsets":
            off = torch.zeros_like(off)
        elif fault == "swapped_windows":
            off = off.roll(1, 0)
        k1 = p1 + off
    return (i.cpu().numpy(), j.cpu().numpy(), v.cpu().numpy(),
            p0.cpu().numpy(), k1.cpu().numpy())


def match_control(cell, seed: int, dev) -> dict:
    """The control of a matching cell, and the fine stage's planted
    faults, on the pairs of its first ``check_batches`` batches."""
    mix, cfg = cell.mix, cell.config
    views, pad, n = mix["views"], mix["pad"], mix["pairs"]
    judged = range(mix["check_batches"] * mix["batch"])
    state = make_state(cfg["widths"], seed, dev)
    P = make_pairs(seed, n, views, pad, dev)
    masked = any((v[0], v[1]) != tuple(pad) or (v[2], v[3]) != tuple(pad)
                 for v in views)
    strict_float32()
    ref_model = Plain(state, cfg["widths"])
    ctl_model = Plain(state, cfg["widths"], quant="fp8")
    no_fine = NoFineTransformer(state, cfg["widths"])
    inf, per_pair = cfg["inference"], []
    faults = {f: [] for f in FINE_FAULTS}
    for p in judged:
        args = (P.image0[p].float() / 255.0, P.image1[p].float() / 255.0,
                P.mask0[p] if masked else None,
                P.mask1[p] if masked else None)
        ref = check.ref_pair(ref_model, *args, inf)
        i, j, v, k0, k1 = control_matches(ctl_model, *args, inf)
        per_pair.append(check.judge_pair(ref, i, j, v, k0, k1))
        for f in FINE_FAULTS:
            model = no_fine if f == "fine_transformer_skipped" else ref_model
            ans = control_matches(model, *args, inf,
                                  None if model is no_fine else f)
            faults[f].append(check.judge_pair(ref, *ans))
    return {"control": check.summarize_matches(per_pair),
            "faults": {f: check.summarize_matches(v)
                       for f, v in faults.items()}}


def train_control(cell, seed: int, dev) -> dict:
    """The training cell's control (fp8 reference steps) and its planted
    fault (the port's first steps on half of each batch)."""
    import torch
    from loftr_tpu_torch.structs import MatchInput
    from bench_port.generators.train import Train, _moved

    drv = Train(cell, seed, dev)
    half = drv.B // 2

    def half_step(batch):
        cut = MatchInput(**{k: (None if v is None else v[:half])
                            for k, v in vars(batch).items()})
        return drv.trainer.train_step(drv.ts, cut)

    drv.setup(steps=half_step)
    drv.free()
    torch.cuda.empty_cache()
    ref = drv.reference()
    out = {"half_batch": check.judge_train(_moved(drv.prog, dev), ref)}
    ctl = drv.reference(quant="fp8")
    out["control"] = check.judge_train(ctl, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        core.say("control.py needs a CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    cell = core.load_cell(args.workload)
    for seed in args.seeds:
        if cell.mix["generator"] == "train":
            rec = train_control(cell, seed, dev)
        else:
            rec = match_control(cell, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "card": core.power_limit(), **rec}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
