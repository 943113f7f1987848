#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``loftr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2,3,4] [--out FILE]

Phases, each of which must pass (any failure exits non-zero):
  1. environment: card name and power limit, versions, kernel build time
     (the kernels build from ``loftr_tpu_torch/csrc`` at first use);
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     shapes of the indoor_ds 640x480 main path, in float32 and bfloat16;
  3. the whole slice in float32, card (kernels) against CPU (plain paths);
  4. the flagship indoor_ds preset in bfloat16 at 640x480: ``match_pair``
     at B=1 and the batched model call at B=8, timed with CUDA events, with
     the per-stage split and peak memory.
The main path (one ``match_pair`` call) runs with every kernel launch
counter set to 0 just before it; the counts read just after it must show
every kernel.  Results go to stdout one JSON object per line; the line
before the last is the kernel summary, and the last line is the contract
line ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside this script, it exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit).  The
# kernels' main-path inputs are bf16, so their operations count against the
# bf16 tensor-core rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

H, W = 480, 640


def emit(obj, log):
    line = json.dumps(obj)
    print(line, flush=True)
    if log is not None:
        log.write(line + "\n")
        log.flush()


def cuda_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes, peak_flops):
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_gap_top2(conf):
    """Relative gap between the two largest values along the last axis."""
    top = conf.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]) / top[..., 0].clamp_min(1e-30)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def kernel_checks(dev, log, results):
    import numpy as np
    import torch
    from loftr_tpu_torch.models.fused_fine import encoder_weights
    from loftr_tpu_torch.models.transformer import LoFTREncoderLayer
    from loftr_tpu_torch.ops.kernels import coarse_layer as KA
    from loftr_tpu_torch.ops.kernels import dual_softmax as KB
    from loftr_tpu_torch.ops.kernels import fine_stage as KC
    from loftr_tpu_torch.utils.weights import init_weights

    rng = np.random.RandomState(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def enc(c, seed):
        layer = init_weights(LoFTREncoderLayer(c, 8), seed).to(dev)
        return encoder_weights(layer)

    # ---- kernel A: coarse layer, C=256, L=S=4800 ------------------------
    C, L = 256, (H // 8) * (W // 8)
    wA = enc(C, 1)
    cases = {
        "self_B2": (rng.randn(2, L, C) * 0.5, None, None, None),
        "cross_B1": (rng.randn(1, L, C) * 0.5, rng.randn(1, L, C) * 0.5,
                     None, None),
        "cross_B1_masked": (rng.randn(1, L, C) * 0.5,
                            rng.randn(1, L, C) * 0.5,
                            rng.rand(1, L) > 0.2, rng.rand(1, L) > 0.2),
    }
    # tolerances: float32 -- the bar of the JAX kernel's own tests
    # (2e-4, test_coarse_layer_fused.py), sums in another order; bfloat16 --
    # a different summation order can flip one bf16 rounding of an
    # intermediate (2^-8 relative), which the next product carries, so the
    # bar is a few output ulps at |y| ~ 4 with a small mean.
    tolA = {f32: (2e-4, 2e-4, None), bf16: (0.125, 0.0, 5e-3)}
    errA = {}
    for name, (x, s, xm, sm) in cases.items():
        for dt in (f32, bf16):
            xt = torch.from_numpy(x).to(dev, dt)
            st = xt if s is None else torch.from_numpy(s).to(dev, dt)
            xmt = None if xm is None else torch.from_numpy(xm).to(dev)
            smt = None if sm is None else torch.from_numpy(sm).to(dev)
            got = KA.fused_coarse_layer(xt, st, wA, xmt, smt, 8)
            want = KA.coarse_layer_plain(xt, st, wA, xmt, smt, 8)
            torch.cuda.synchronize()
            d = (got.float() - want.float()).abs()
            atol, rtol, mean_tol = tolA[dt]
            ok = bool((d <= atol + rtol * want.float().abs()).all())
            if mean_tol is not None:
                ok = ok and float(d.mean()) <= mean_tol
            rec = {"phase": 2, "kernel": "coarse_layer", "case": name,
                   "dtype": str(dt)[6:], "max_abs_err": float(d.max()),
                   "mean_abs_err": float(d.mean()), "atol": atol,
                   "rtol": rtol, "mean_tol": mean_tol, "ok": ok}
            emit(rec, log)
            check(ok, f"coarse_layer {name} {dt} disagrees: {rec}")
            errA[(name, dt)] = float(d.max())
    # timing at the packed-self shape in bf16 (the main path's largest call)
    xt = torch.from_numpy(cases["self_B2"][0]).to(dev, bf16)
    packed = KC.pack_weights(wA, bf16)
    ms = cuda_ms(lambda: KA.fused_coarse_layer(xt, xt, wA, None, None, 8,
                                               packed=packed))
    plain = cuda_ms(lambda: KA.coarse_layer_plain(xt, xt, wA, None, None, 8),
                    iters=5)
    # per x row: q, merge, FFN (8 C^2 MACs), per-head KV apply and
    # normaliser; per source row: k, v (2 C^2) and the per-head KV blocks.
    # Bytes: x, src and out once each, the weights once.
    rows = 2 * L
    flops = 2 * (rows * (8 * C * C + C * (C // 8) + C)
                 + rows * (2 * C * C + C * (C // 8)))
    nbytes = 2 * rows * C * 2 + rows * C * 2 + 10 * C * C * 2 + 4 * C * 4
    b, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    results["coarse_layer"] = dict(
        max_abs_err=errA[("self_B2", bf16)], ms=ms, plain_ms=plain,
        bound_ms=b, bound_by=by, library_ms=None,
        shape="x=src [2,4800,256] bf16")

    # ---- kernel B: dual softmax, L=S=4800, C=256 -------------------------
    f0 = rng.randn(1, L, C).astype(np.float32)
    f1 = rng.randn(1, L, C).astype(np.float32)
    ii, jj = rng.permutation(L)[:400], rng.permutation(L)[:400]
    f1[0, jj] = f0[0, ii] + 0.1 * rng.randn(400, C)
    masks = (rng.rand(1, L) > 0.1, rng.rand(1, L) > 0.1)
    errB = {}
    for masked in (False, True):
        for dt in (f32, bf16):
            a = torch.from_numpy(f0).to(dev, dt)
            bb = torch.from_numpy(f1).to(dev, dt)
            m0 = torch.from_numpy(masks[0]).to(dev) if masked else None
            m1 = torch.from_numpy(masks[1]).to(dev) if masked else None
            bv, bj, cc = KB.fused_dual_softmax_match(a, bb, 0.1, m0, m1)
            pv, pj, pc = KB.dual_softmax_plain(a, bb, 0.1, m0, m1)
            # the plain conf, to explain argmax differences by near-ties
            B_, L_, C_ = a.shape
            sim = torch.matmul(a.float(), bb.float().transpose(1, 2))
            sim = sim / (C_ * 0.1)
            mm0 = torch.ones(1, L_, device=dev) if m0 is None else m0.float()
            mm1 = torch.ones(1, L_, device=dev) if m1 is None else m1.float()
            sim = sim + (mm0[:, :, None] * mm1[:, None, :] - 1.0) * 1e9
            conf = torch.softmax(sim, 2) * torch.softmax(sim, 1)
            row_gap = rel_gap_top2(conf)[0]
            col_gap = rel_gap_top2(conf.transpose(1, 2))[0]
            del sim, conf
            # valid as the epilogue forms it (thr 0.2, MNN), both versions
            vk = (bv > 0.2) & (bv >= torch.gather(cc, 1, bj.long()))
            vp = (pv > 0.2) & (pv >= torch.gather(pc, 1, pj.long()))
            torch.cuda.synchronize()
            j_diff = (bj != pj)[0]
            v_diff = (vk != vp)[0]
            near = (row_gap < 1e-6) | (col_gap[pj[0].long()] < 1e-6)
            unexplained = int(((j_diff | v_diff) & ~near).sum())
            dv = float((bv - pv).abs().max())
            dc = float((cc - pc).abs().max())
            # tolerance: conf in [0, 1], float exps of sims that differ by
            # the summation order of a C=256 dot (the JAX test bar, 1e-4
            # relative; 1e-6 absolute for tiny values)
            okv = bool(((bv - pv).abs() <= 1e-6 + 1e-4 * pv.abs()).all())
            okc = bool(((cc - pc).abs() <= 1e-6 + 1e-4 * pc.abs()).all())
            rec = {"phase": 2, "kernel": "dual_softmax", "masked": masked,
                   "dtype": str(dt)[6:], "best_val_max_abs_err": dv,
                   "colconf_max_abs_err": dc,
                   "best_j_mismatch": int(j_diff.sum()),
                   "valid_mismatch": int(v_diff.sum()),
                   "near_tie_rows_1e-6": int(near.sum()),
                   "unexplained_mismatch": unexplained,
                   "n_valid": int(vk.sum()), "ok": okv and okc
                   and unexplained == 0}
            emit(rec, log)
            check(rec["ok"], f"dual_softmax disagrees: {rec}")
            errB[(masked, dt)] = max(dv, dc)
    a = torch.from_numpy(f0).to(dev, bf16)
    bb = torch.from_numpy(f1).to(dev, bf16)
    ms = cuda_ms(lambda: KB.fused_dual_softmax_match(a, bb, 0.1))
    plain = cuda_ms(lambda: KB.dual_softmax_plain(a, bb, 0.1), iters=5)
    # both passes' sim products (exponentials not counted); features in,
    # best value + index per row and column max out
    flops = 2 * 2 * L * L * C
    nbytes = 2 * L * C * 2 + L * 8 + L * 4
    b, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    results["dual_softmax"] = dict(
        max_abs_err=errB[(False, bf16)], ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None, shape="f0=f1 [1,4800,256] bf16")

    # ---- kernel C: fine stage, NB=1024, 25, C=128 ------------------------
    Cf, NB = 128, 1024
    l0, l1 = enc(Cf, 2), enc(Cf, 3)
    w0 = rng.randn(NB, 25, Cf) * 0.5
    w1 = rng.randn(NB, 25, Cf) * 0.5
    # float32: the JAX kernel test's bar (2e-4, test_fine_stage_fused.py);
    # bfloat16: the soft-argmax of features that may differ by one bf16
    # rounding flip, in window coordinates [-1, 1]
    tolC = {f32: 2e-4, bf16: 5e-2}
    errC = {}
    for dt in (f32, bf16):
        a = torch.from_numpy(w0).to(dev, dt)
        bb = torch.from_numpy(w1).to(dev, dt)
        got = KC.fused_fine_stage(a, bb, l0, l1, 8)
        want = KC.fine_stage_plain(a, bb, l0, l1, 8)
        torch.cuda.synchronize()
        d = (got - want).abs()
        ok = bool((d <= tolC[dt] + tolC[dt] * want.abs()).all())
        rec = {"phase": 2, "kernel": "fine_stage", "dtype": str(dt)[6:],
               "max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
               "atol": tolC[dt], "rtol": tolC[dt], "ok": ok}
        emit(rec, log)
        check(ok, f"fine_stage disagrees: {rec}")
        errC[dt] = float(d.max())
    a = torch.from_numpy(w0).to(dev, bf16)
    bb = torch.from_numpy(w1).to(dev, bf16)
    ms = cuda_ms(lambda: KC.fused_fine_stage(a, bb, l0, l1, 8))
    plain = cuda_ms(lambda: KC.fine_stage_plain(a, bb, l0, l1, 8), iters=5)
    # 4 encoder applications x 25 rows of 10 C^2 MACs, plus score-form
    # attention (25 scores and 25 taps per row), per window pair
    flops = NB * (2 * 100 * 10 * Cf * Cf + 2 * 2 * 100 * 25 * Cf)
    nbytes = 2 * NB * 25 * Cf * 2 + NB * 3 * 4 + 2 * 10 * Cf * Cf * 2
    b, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    results["fine_stage"] = dict(
        max_abs_err=errC[bf16], ms=ms, plain_ms=plain, bound_ms=b,
        bound_by=by, library_ms=None, shape="win0=win1 [1024,25,128] bf16")
    for k, v in results.items():
        emit({"phase": 2, "kernel": k, "timing": v}, log)


def reset_counts():
    from loftr_tpu_torch.ops.kernels.coarse_layer import fused_coarse_layer
    from loftr_tpu_torch.ops.kernels.dual_softmax import \
        fused_dual_softmax_match
    from loftr_tpu_torch.ops.kernels.fine_stage import fused_fine_stage
    for fn in (fused_coarse_layer, fused_dual_softmax_match,
               fused_fine_stage):
        fn.launches = 0


def read_counts():
    from loftr_tpu_torch.ops.kernels.coarse_layer import fused_coarse_layer
    from loftr_tpu_torch.ops.kernels.dual_softmax import \
        fused_dual_softmax_match
    from loftr_tpu_torch.ops.kernels.fine_stage import fused_fine_stage
    return {"coarse_layer": fused_coarse_layer.launches,
            "dual_softmax": fused_dual_softmax_match.launches,
            "fine_stage": fused_fine_stage.launches}


def images(seed, batch=1):
    """Seeded grayscale pairs: smooth random fields, the second a shifted
    view of the first plus noise (so the pair has true correspondences)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out0, out1 = [], []
    for _ in range(batch):
        base = rng.rand(H // 8 + 8, W // 8 + 8)
        big = np.kron(base, np.ones((8, 8)))
        big = (big + np.roll(big, 4, 0) + np.roll(big, 4, 1)) / 3
        out0.append(big[:H, :W])
        sh = big[13:13 + H, 21:21 + W]
        out1.append(np.clip(sh + 0.05 * rng.randn(H, W), 0, 1))
    return (np.stack(out0).astype(np.float32),
            np.stack(out1).astype(np.float32))


# --------------------------------------------------------------------------
# phase 3: the slice in float32, card against CPU
# --------------------------------------------------------------------------

def slice_fp32(dev, log):
    import numpy as np
    import torch
    from loftr_tpu_torch.api import load_matcher, with_config
    from loftr_tpu_torch.structs import MatchInput

    model = with_config(load_matcher(seed=0, device=dev), {
        "dtype": "float32", "match_coarse": {"thr": 0.0, "border_rm": 0}})
    cpu_model = copy.deepcopy(model).cpu()
    i0, i1 = images(1)
    inp_d = MatchInput(image0=torch.from_numpy(i0[..., None]).to(dev),
                       image1=torch.from_numpy(i1[..., None]).to(dev))
    inp_c = MatchInput(image0=torch.from_numpy(i0[..., None]),
                       image1=torch.from_numpy(i1[..., None]))
    reset_counts()
    out_d = model(inp_d)
    torch.cuda.synchronize()
    counts = read_counts()
    emit({"phase": 3, "launches_one_forward": counts}, log)
    check(counts == {"coarse_layer": 12, "dual_softmax": 1, "fine_stage": 1},
          f"unexpected launch counts {counts}")
    t0 = time.perf_counter()
    out_c = cpu_model(inp_c)
    cpu_s = time.perf_counter() - t0

    def np_(t):
        return t.detach().float().cpu().numpy()

    vd, vc = np_(out_d.valid) > 0, np_(out_c.valid) > 0
    same_ids = ((np_(out_d.coarse.i_ids) == np_(out_c.coarse.i_ids))
                & (np_(out_d.coarse.j_ids) == np_(out_c.coarse.j_ids)))
    frac = float(same_ids.mean())
    dk = np.abs(np_(out_d.mkpts1_f) - np_(out_c.mkpts1_f)).max(-1)[same_ids]
    dconf = np.abs(np_(out_d.coarse.mconf) - np_(out_c.coarse.mconf))[same_ids]
    dexp = np.abs(np_(out_d.expec_f) - np_(out_c.expec_f)).max(-1)[same_ids]
    rec = {"phase": 3, "n_valid_card": int(vd.sum()),
           "n_valid_cpu": int(vc.sum()),
           "valid_agree": float((vd == vc).mean()),
           "ids_agree_frac": frac,
           "mkpts1_f_max_abs_px": float(dk.max()) if dk.size else 0.0,
           "mconf_max_abs": float(dconf.max()) if dconf.size else 0.0,
           "expec_f_max_abs": float(dexp.max()) if dexp.size else 0.0,
           "cpu_forward_s": cpu_s,
           "ok": frac >= 0.99 and (dk.size == 0 or float(dk.max()) <= 1e-2)}
    emit(rec, log)
    check(rec["ok"], f"fp32 slice: card and CPU disagree: {rec}")
    check(int(vd.sum()) > 0, "fp32 slice found no valid matches")


# --------------------------------------------------------------------------
# phase 4: the flagship in bfloat16
# --------------------------------------------------------------------------

def flagship_bf16(dev, log):
    import numpy as np
    import torch
    from loftr_tpu_torch.api import load_matcher, match_pair, with_config
    from loftr_tpu_torch.structs import MatchInput

    matcher = load_matcher(seed=0, device=dev)           # indoor_ds
    i0, i1 = images(2)
    img0 = (i0[0] * 255).astype(np.uint8)
    img1 = (i1[0] * 255).astype(np.uint8)

    # the main path, once, through the user entry point
    match_pair(img0, img1, matcher)                      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    out = match_pair(img0, img1, matcher)
    torch.cuda.synchronize()
    main_counts = read_counts()
    check(all(np.isfinite(out[k]).all() for k in out), "non-finite output")
    check(out["mkpts0"].shape == out["mkpts1"].shape
          and out["mkpts0"].shape[0] == out["mconf"].shape[0],
          "match_pair output shapes disagree")
    emit({"phase": 4, "main_path": "match_pair indoor_ds bf16 640x480",
          "launches": main_counts, "n_matches": int(out["mconf"].shape[0])},
         log)
    check(all(v > 0 for v in main_counts.values()),
          f"a kernel of the main path did not launch: {main_counts}")

    t_mp = cuda_ms(lambda: match_pair(img0, img1, matcher), iters=10)
    model = with_config(matcher, {"dtype": "bfloat16"})
    timings = {"match_pair_B1_ms": t_mp}
    for B in (1, 8):
        a, b = images(3, B)
        inp = MatchInput(image0=torch.from_numpy(a[..., None]).to(dev),
                         image1=torch.from_numpy(b[..., None]).to(dev))
        torch.cuda.reset_peak_memory_stats()
        res = model(inp)
        check(bool(torch.isfinite(res.mkpts1_f).all())
              and bool(torch.isfinite(res.expec_f).all()),
              "non-finite model output")
        ms = cuda_ms(lambda: model(inp), iters=10)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        # per-stage split: the stages run one by one, each timed alone
        with torch.no_grad():
            f = model.extract(inp)
            fc = model.coarse(f)
            m, _ = model.match(fc, inp)
            stage = {
                "backbone_ms": cuda_ms(lambda: model.extract(inp)),
                "coarse_ms": cuda_ms(lambda: model.coarse(f)),
                "match_ms": cuda_ms(lambda: model.match(fc, inp)),
                "fine_ms": cuda_ms(lambda: model.fine(fc, m, inp)),
            }
        rec = {"phase": 4, "batch": B, "ms_per_batch": ms,
               "ms_per_pair": ms / B, "pairs_per_s": 1000.0 * B / ms,
               "peak_mem_MiB": peak, **stage}
        timings[f"B{B}"] = rec
        emit(rec, log)
    emit({"phase": 4, "match_pair_B1_ms": t_mp}, log)
    return main_counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4")
    ap.add_argument("--out", default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    if not os.path.isdir(os.path.join(REPO, "loftr_tpu_torch")):
        print("chip_smoke.py: the loftr_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    dev = torch.device("cuda", 0)
    log = None
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        log = open(args.out, "a")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        # exactness phases compare float32 math: no TF32 anywhere
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        from loftr_tpu_torch.ops.kernels import _build
        t0 = time.perf_counter()
        _build.library()
        emit({"phase": 1, "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0],
              "kernel_build_s": _build.build_seconds,
              "kernel_load_s": time.perf_counter() - t0,
              "tf32": "cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False"},
             log)
        results = {}
        torch.set_grad_enabled(False)  # inference only
        if 2 in phases:
            kernel_checks(dev, log, results)
        if 3 in phases:
            slice_fp32(dev, log)
        main_counts = None
        if 4 in phases:
            main_counts = flagship_bf16(dev, log)
        if results and main_counts is not None:
            src = {"coarse_layer": ("loftr_tpu_torch/csrc/coarse_layer.cu",
                                    "loftr_tpu/ops/pallas/coarse_layer.py:117"),
                   "dual_softmax": ("loftr_tpu_torch/csrc/dual_softmax.cu",
                                    "loftr_tpu/ops/pallas/dual_softmax.py:132"),
                   "fine_stage": ("loftr_tpu_torch/csrc/fine_stage.cu",
                                  "loftr_tpu/ops/pallas/fine_stage.py:263")}
            kernels = []
            for name, r in results.items():
                kernels.append({
                    "name": name, "route": "cuda", "source": src[name][0],
                    "replaces": src[name][1],
                    "launches": main_counts[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
            print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    finally:
        if log is not None:
            log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
