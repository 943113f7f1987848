"""What decides ``correct``: the port's outputs judged against the plain
float32 reference (``reference/``), which works everything out again from
the benchmark's own weights and inputs and reads the port's outputs only to
judge them.  Which of the numbers below a cell compares, and their limits,
are in its workload file; the others are printed as readings.

Matching, per pair of a sampled batch, over the port's valid
matches (i, j):

- ``odd``: the share of matches whose gap exceeds 0.5, the gap being how
  far the reference's confidence at (i, j) lies below the best of row i,
  of column j, and (where the reference finds K candidates or more) of
  its K-th candidate, as a share of that best.  Rounding swaps near-ties;
  a wrong match lies far below.  (With seeded random weights the
  similarities are large and bf16 moves single confidences by several
  times, so the widest gap, ``gap_max``, reaches 1 in sound runs.)
- ``illegal``: matches that break the border, the padding mask or the
  grid (exact: limit 0).
- ``mconf``: the median relative error of the port's confidence against
  the reference's at (i, j).
- ``kpt0_px``: the largest distance between the port's keypoint in image
  0 and cell i's coarse point (exact: limit 0).
- ``fine_outside``: refined keypoints outside their cell's fine window
  (exact: limit 0).  A keypoint that is not a number lies outside.
- ``nonfinite``: confidences and keypoints of the port's valid matches
  that are not finite numbers (exact: limit 0).
- readings: ``count`` (|the port's matches - the reference's| / the
  reference's), ``fine_px`` (the median distance between the port's
  refined keypoint in image 1 and the reference's fine stage at (i, j))
  and ``fine_z`` (that distance over the reference heatmap's spread).

The fine stage (kernel C) is held only to its window and to finite
numbers: with seeded random weights no statistic of its offsets lies
three times apart between sound runs and the float8 control, and planted
faults of the stage (offsets zeroed, the fine transformer skipped) read
inside the sound runs' range on some seeds (``control.py``).

Training, the first three steps of the window's own ``train_step``:

- ``loss_c1``: the first step's coarse loss, relative error.
- ``gnorm1``: the first step's gradient norm before clipping, relative
  error.
- ``grad_median`` and ``delta_median``: the first clipped gradient (as the
  optimizer holds it after one step) and the parameters' change over the
  three steps, each by the median leaf: the gap of the norms over the
  larger of the reference leaf's norm and the median leaf's; leaves whose
  reference gradient is under a thousandth of the median leaf's are left
  out of the change.
- readings: the same by the worst leaf (``grad``, ``delta``, with the
  leaf's name), every step's loss (``loss``, ``loss_c``), the first step's
  fine loss (``loss_f1``) and its largest slot weight (``weight_max1``),
  and ``grad_dir`` (the median leaf's |g_port - g_ref| / |g_ref|).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench_port.reference.loftr_plain import Plain, border_ok, match_pair


def ref_pair(model: Plain, img0, img1, mask0, mask1, cfg: dict) -> dict:
    """The reference of one pair: images [H, W] float in [0, 1] on the
    device, coarse masks [h, w] or None."""
    m0 = None if mask0 is None else mask0[None]
    m1 = None if mask1 is None else mask1[None]
    with torch.no_grad():
        c0, c1, f0, f1, mm0, mm1 = model.features(img0[None], img1[None],
                                                  m0, m1)
        hw0 = (img0.shape[0] // 8, img0.shape[1] // 8)
        hw1 = (img1.shape[0] // 8, img1.shape[1] // 8)
        conf, best, i_r, j_r, v_r = match_pair(
            model, c0[0], c1[0], None if mm0 is None else mm0[0],
            None if mm1 is None else mm1[0], hw0, hw1, cfg["thr"],
            cfg["border_rm"], cfg["max_matches"], mask0=mask0, mask1=mask1)
    return {"model": model, "conf": conf, "best": best, "c0": c0[0],
            "c1": c1[0], "f0": f0[0], "f1": f1[0], "hw0": hw0, "hw1": hw1,
            "n": int(i_r.numel()), "v_sorted": v_r, "k": cfg["max_matches"],
            "ok0": border_ok(hw0, cfg["border_rm"], mask0),
            "ok1": border_ok(hw1, cfg["border_rm"], mask1)}


def judge_pair(ref: dict, i, j, mconf, kpt0, kpt1) -> dict:
    """The port's valid matches of one pair against its reference.  i, j:
    int arrays [M]; mconf [M]; kpt0, kpt1 [M, 2] pixels (x, y)."""
    dev = ref["c0"].device
    i = torch.as_tensor(np.asarray(i), dtype=torch.long, device=dev)
    j = torch.as_tensor(np.asarray(j), dtype=torch.long, device=dev)
    n = int(i.numel())
    out = {"n": n, "n_ref": ref["n"]}
    out["count"] = abs(n - ref["n"]) / max(ref["n"], 1)
    if n == 0:
        out.update(gap=0.0, odd=0, illegal=0, mconf=[], fine_px=[],
                   fine_z=[], kpt0_px=0.0, fine_outside=0, nonfinite=0)
        return out
    L, S = ref["c0"].shape[0], ref["c1"].shape[0]
    inside = (i >= 0) & (i < L) & (j >= 0) & (j < S)
    ic, jc = i.clamp(0, L - 1), j.clamp(0, S - 1)
    conf = ref["conf"]
    with torch.no_grad():
        rv, _, cv, _ = ref["best"]
        c = conf.conf_rows(ic).gather(1, jc[:, None])[:, 0]
        gap = torch.maximum((rv[ic] - c) / rv[ic].clamp_min(1e-30),
                            (cv[jc] - c) / cv[jc].clamp_min(1e-30))
        if ref["n"] >= ref["k"]:
            kth = ref["v_sorted"][ref["k"] - 1]
            gap = torch.maximum(gap, (kth - c) / kth.clamp_min(1e-30))
        legal = inside & ref["ok0"].to(dev)[ic] & ref["ok1"].to(dev)[jc]
        gap = torch.where(legal, gap.clamp_min(0.0), torch.ones_like(gap))
        out["gap"] = float(gap.max())
        out["odd"] = int((gap > 0.5).sum())
        out["illegal"] = int((~legal).sum())
        mc = torch.as_tensor(np.asarray(mconf), dtype=torch.float32,
                             device=dev)
        out["mconf"] = ((mc - c).abs() / c.clamp_min(1e-30)).tolist()
        expec = ref["model"].fine(ref["c0"], ref["c1"], ref["f0"],
                                  ref["f1"], ic, jc, ref["hw0"], ref["hw1"])
        wc0, wc1 = ref["hw0"][1], ref["hw1"][1]
        p0 = torch.stack([(ic % wc0), (ic // wc0)], -1).float() * 8
        p1 = torch.stack([(jc % wc1), (jc // wc1)], -1).float() * 8
        delta = expec[:, :2] * 2 * 2
        k0 = torch.as_tensor(np.asarray(kpt0), dtype=torch.float32,
                             device=dev)
        k1 = torch.as_tensor(np.asarray(kpt1), dtype=torch.float32,
                             device=dev)
        err = (k1 - (p1 + delta)).norm(dim=-1)
        out["fine_px"] = err.tolist()
        # the error in units of the reference heatmap's spread (its summed
        # standard deviation, in pixels): flat heatmaps move more
        out["fine_z"] = (err / (expec[:, 2] * 4).clamp_min(1e-6)).tolist()
        out["kpt0_px"] = float((k0 - p0).norm(dim=-1).max())
        # a refined keypoint lies inside its cell's window: at most half a
        # window (2 fine pixels of 2 px: 4 px) from the coarse point
        out["fine_outside"] = int((~((k1 - p1).abs() <= 4.0 + 1e-3))
                                  .any(-1).sum())
        out["nonfinite"] = int((~torch.isfinite(mc)).sum()
                               + (~torch.isfinite(k0)).any(-1).sum()
                               + (~torch.isfinite(k1)).any(-1).sum())
    return out


def summarize_matches(per_pair: List[dict]) -> Dict[str, float]:
    """The compared numbers over every judged pair (infinite where no
    pair was judged: nothing came back to compare)."""
    if not per_pair:
        inf = float("inf")
        return {k: inf for k in ("odd", "illegal", "mconf", "fine_px",
                                 "kpt0_px", "fine_outside", "nonfinite")}
    mconf = [x for p in per_pair for x in p["mconf"]]
    fine = [x for p in per_pair for x in p["fine_px"]]
    fz = [x for p in per_pair for x in p["fine_z"]]
    n = max(1, sum(p["n"] for p in per_pair))
    return {"gap_max": max(p["gap"] for p in per_pair),
            "odd": sum(p["odd"] for p in per_pair) / n,
            "illegal": sum(p["illegal"] for p in per_pair),
            "count": max(p["count"] for p in per_pair),
            "mconf": float(np.median(mconf)) if mconf else 0.0,
            "fine_px": float(np.median(fine)) if fine else 0.0,
            "fine_z": float(np.median(fz)) if fz else 0.0,
            "kpt0_px": max(p["kpt0_px"] for p in per_pair),
            "fine_outside": sum(p["fine_outside"] for p in per_pair),
            "nonfinite": sum(p["nonfinite"] for p in per_pair),
            "pairs": len(per_pair),
            "matches": sum(p["n"] for p in per_pair)}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def judge_train(prog: dict, ref: dict) -> Dict[str, float]:
    """Both sides' ``losses`` [3], their coarse terms ``coarse`` [3],
    ``grad1`` and ``delta`` (dicts by parameter name)."""
    rel = lambda a, b: np.abs(np.asarray(a) - np.asarray(b)) / np.abs(
        np.asarray(b))
    f_p, f_r = prog["first"], ref["first"]
    out = {"loss_c1": float(rel(prog["coarse"], ref["coarse"])[0]),
           "loss_f1": float(rel(f_p["loss_f"], f_r["loss_f"])),
           "gnorm1": float(rel(f_p["grad_norm"], f_r["grad_norm"])),
           "weight_max1": f_r.get("weight_max"),
           "loss_c": float(np.max(rel(prog["coarse"], ref["coarse"]))),
           "loss": float(np.max(rel(prog["losses"], ref["losses"]))),
           "loss_step1": float(rel(prog["losses"], ref["losses"])[0])}
    gp, gr = _norms(prog["grad1"]), _norms(ref["grad1"])
    gmed = float(np.median(list(gr.values())))
    gap = {k: abs(gp[k] - gr[k]) / max(gr[k], gmed) for k in gr}
    out["grad"] = max(gap.values())
    out["grad_median"] = float(np.median(list(gap.values())))
    # the direction too: the median leaf's |g_port - g_ref| / |g_ref|
    out["grad_dir"] = float(np.median([
        float((prog["grad1"][k] - ref["grad1"][k]).double().norm())
        / max(gr[k], 1e-30) for k in gr if gr[k] >= 1e-3 * gmed]))
    out["grad_worst_leaf"] = max(gap, key=gap.get)
    keep = [k for k in gr if gr[k] >= 1e-3 * gmed]
    dp, dr = _norms(prog["delta"]), _norms(ref["delta"])
    dmed = float(np.median([dr[k] for k in keep]))
    gap = {k: abs(dp[k] - dr[k]) / max(dr[k], dmed) for k in keep}
    out["delta"] = max(gap.values())
    out["delta_median"] = float(np.median(list(gap.values())))
    out["delta_worst_leaf"] = max(gap, key=gap.get)
    out["leaves_left_out"] = len(gr) - len(keep)
    return out
