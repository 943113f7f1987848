#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``loftr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2,3,4,5,6,7,8,9,10,11] [--out FILE]

Phases, each of which must pass (any failure exits non-zero):
  1. environment: card name and power limit, versions, kernel build time
     (the kernels build from ``loftr_tpu_torch/csrc`` at first use),
     ``ptxas`` registers, and each kernel's SASS size (``cuobjdump -sass``
     of each object, read while phase 2 runs); fails if a kernel of
     ``coarse_layer.cu`` or ``fine_stage.cu``, or a bf16 kernel of
     ``dual_softmax.cu``, ``sinkhorn.cu``, ``focal_loss.cu``,
     ``window_attention.cu`` or ``upsample.cu``, spills;
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     shapes of the indoor_ds 640x480 main paths, in float32 and bfloat16
     (the coarse layer also at ragged masked lengths, and timed at both of
     its launch shapes, self [2,4800,256] and cross [1,4800,256]; the
     fine stage at 1024, 8192, 1920, 1021, 7 and 1 window pairs, timed at
     the first two with its pairs a block; the dual softmax at
     [1,4800,256] unmasked and masked, [8,4800,256] masked, a ragged masked
     pair L=4700 / S=4750 at B=2, L=S=7 and S=11025, timed at B=1 and B=8;
     the focal-loss kernels: sums and both gradients in both dtypes at
     B=2, the training batch (unmasked, masked, without positives), at a
     ragged masked pair L=4700 / S=4750, L=S=7, L=4800 / S=1200 and its
     mirror, gamma 1.5, C=128 and a forward without a graph, timed at B=1
     and B=2 (events and profiled device time); the hybrid fine stage:
     its gradients against autograd of the plain fine stage; the Sinkhorn
     kernel at B=2 and B=1, masked and unmasked, ``prefilter`` off and on,
     at a ragged masked pair L=4700 / S=4750 at B=2, L=S=7, and L=4800 /
     S=1200 and its mirror, timed at B=1 and B=8 with ``prefilter`` off and
     on; the window-attention kernel in both dtypes at 2048, 1024, 1021, 7
     and 1 windows of 25 x 128 with 8 heads and at [64,9,64] with 2 heads,
     timed at 2048 and 1024 (events and profiled device time); the upsample
     kernel in both dtypes at the backbone's [2,256,60,80] and
     [2,196,120,160], [1,3,5,7], [1,4,1,9] and [2,8,7,80], timed at the
     first two);
  3. the inference slice in float32, card (kernels) against CPU (plain);
  4. the flagship indoor_ds preset in bfloat16 at 640x480: ``match_pair``
     at B=1 and the batched model call at B=8, timed with CUDA events, with
     the per-stage split (the coarse stage also with ``coarse.use_pallas``
     off, the plain layer stack; the match and fine stages also as
     profiled device time, kernel B's bf16 path and kernel C against the
     whole stage) and peak memory;
  5. one float32 ``Trainer.train_step`` at indoor_ds width, 640x480, B=2:
     card (kernels) against CPU (plain versions), same weights, batch and
     selection noise;
  6. the training main path in bfloat16: 8 ``Trainer.train_step`` calls on
     one batch at B=2 (and B=4), then 5 more timed one by one with CUDA
     events, the stage split, peak memory and kernel D's profiled device
     time a step; the last loss of the 8 must be finite and below the
     first;
  7. the OT inference slice (``indoor_ot``) in float32, card against CPU;
  8. the OT main path in bfloat16 at 640x480: ``match_pair`` with
     ``indoor_ot`` at B=1 and the batched model call at B=8, timed as in
     phase 4 (the match stage's device time split into kernel E's bf16
     passes and combines); then, once each at B=1, the backbone with the
     upsample switch on and the fine layer stack with ``fused_window_attn``
     on, each compared with the switch off;
  9. ``Trainer.train_step`` with ``indoor_ot`` in bfloat16 at B=2: 4 steps,
     finite losses, a finite non-zero gradient into ``bin_score``;
 10. the evaluation path: synthetic MegaDepth scenes (2 x 3 views, 6
     pairs) at 840 px, ``loftr_tpu_torch.test.main`` with full-width
     ``outdoor_ds`` in bfloat16 (L = S = 11025, K = 2048, thr 0) once with
     each pose solver (``batched``, ``opencv``, ``native``, ``5pt``,
     ``batched5pt``; the JSON keys of ``test.py``, finite); the device
     solvers within 0.1 deg of the ground-truth pose on 500 exact
     correspondences, also with 30% of them random (the host solvers
     within 2 deg, a cross-check); the card's epipolar errors against the
     CPU's (rtol 1e-5); eval pairs/s, the model call's ms and each
     solver's ms per pair;
 11. the training CLI: ``loftr_tpu_torch.train.cli.main`` in-process with
     full-width ``outdoor_ds`` in bfloat16 at 840 px (B=1) on synthetic
     MegaDepth scenes, some views cropped to 3:2 and 2:3 (partial padding
     masks in its steps), 2 epochs of 4 steps with validation (batched
     solver, one figure where ``matplotlib`` is present) and checkpoints
     each epoch: finite losses, the val keys, ``auc@10`` in the checkpoint
     index, kernels A, B, C and D launched; kernel D against its plain
     version at [1, 11025, 256] with K = 3307 planted ground-truth cells
     and 3:2 against 2:3 padding masks, forward and backward, float32 and
     bf16;
     ``--resume`` loads the saved tensors bit for bit and continues from the
     saved step; ms/step from the logger and from CUDA events around
     ``Trainer.train_step``, val pairs/s, checkpoint size and save time,
     peak memory; then the short accuracy smoke (``synthetic_benchmark``,
     the small model at 256 px, 300 steps): the loss falls below a quarter
     and trained auc@20 exceeds untrained.
Each main path (one ``match_pair`` call of each preset; the 8 training
steps; the two switch runs; the CLI's ``batched`` run; the train CLI's
first run) runs with every
kernel launch counter set to 0 just before it; the counts read just after
it must show every kernel of that path.  ``--phases 5,6`` runs only the
indoor_ds training, ``--phases 10`` only the evaluation path, ``--phases
11`` only the training CLI.  Results go
to stdout one JSON object per line; the line before the last is the kernel
summary, and the last line is the contract line ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the package beside this script, it exits
with code 2 and prints no result.
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
# bf16 tensor-core rate; products with a float32 operand (the focal-loss
# gradient products) count against the float32 rate outside the tensor cores.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

H, W = 480, 640
# the combine kernels of the two matchers' bf16 paths, as the profiler names
# them (device_ms)
MATCH_COMBINES = {
    "dual_softmax": ("bf::stats_combine", "bf::best_combine"),
    "sinkhorn": ("bin_kernel", "u_combine_kernel", "v_combine_kernel",
                 "row_best_kernel", "col_best_kernel")}


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


def device_ms(fn, iters=10, tries=3):
    """Device time per call of ``fn`` from the profiler, by kernel, with the
    sum under "total"; None when the profiler sees no device time in any of
    ``tries`` windows (a window now and then records no kernel at all)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0) or 0
            if t > 0:
                base = (e.key.replace("(anonymous namespace)::", "")
                        .split("(")[0].replace("void ", ""))
                name = (base[len("loftr::"):] if base.startswith("loftr::")
                        else base.split("<")[0].split("::")[-1])
                per[name] = per.get(name, 0.0) + t / iters / 1e3
        if per:
            return {"total": sum(per.values()), **per}
    return None


def range_device_ms(fn, ops, iters=3, tries=3):
    """Device time per call of ``fn`` of the kernels launched inside the
    CPU ops named in ``ops`` (an autograd Function's forward shows as its
    class name, its backward as the name + "Backward"), from the profiler,
    by kernel, with the sum under "total"; None when the profiler links no
    device time to them in any of ``tries`` windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()

    def walk(e, per):
        for k in e.kernels:
            base = k.name.replace("(anonymous namespace)::", "").split("(")[0]
            base = base.replace("void ", "")
            name = (base[len("loftr::"):] if base.startswith("loftr::")
                    else base.split("<")[0].split("::")[-1])
            per[name] = per.get(name, 0.0) + k.duration / iters / 1e3
        for c in e.cpu_children:
            walk(c, per)

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.name in ops:
                walk(e, per)
        if per:
            return {"total": sum(per.values()), **per}
    return None


def ptxas_summary():
    """From the loaded kernel library's ``ptxas -v`` build log: registers of
    each kernel of coarse_layer.cu and fine_stage.cu and of the bf16 passes
    of dual_softmax.cu, sinkhorn.cu and focal_loss.cu, and every kernel of
    any source that spills."""
    import re
    from loftr_tpu_torch.ops.kernels import _build
    path = os.path.join(_build.build_dir, "build.log")
    if not os.path.exists(path):
        return None
    regs, fregs, bregs, eregs, dregs, spills = {}, {}, {}, {}, {}, []
    wregs = {}
    src = name = None
    for line in open(path):
        if line.startswith("== "):
            src = line[3:].strip()
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and (int(m.group(1)) or int(m.group(2))):
            spills.append(f"{src}:{name}")
        m = re.search(r"Used (\d+) registers", line)
        if m and name and src == "coarse_layer.cu":
            k = re.search(r"(apply_bf16|apply_kernel|kv_partial_bf16|"
                          r"kv_partial_kernel|kv_reduce_kernel)"
                          r"(?:ILi(\d+)E)?", name)
            short = (name if k is None else k.group(1) + (
                f"<{k.group(2)}>" if k.group(2) else ""))
            regs[short] = int(m.group(1))
        if m and name and src == "dual_softmax.cu":
            k = re.search(r"dual_softmax_bf16ILi(\d)ELi(\d)ELi(\d)ELi(\d)E",
                          name)
            if k:
                bregs["dual_softmax_bf16<%s>" % ", ".join(k.groups())] = \
                    int(m.group(1))
        if m and name and src == "sinkhorn.cu":
            k = re.search(r"sinkhorn_bf16ILi(\d)ELi(\d)ELi(\d)ELi(\d)E", name)
            if k:
                eregs["sinkhorn_bf16<%s>" % ", ".join(k.groups())] = \
                    int(m.group(1))
        if m and name and src == "focal_loss.cu":
            k = re.search(r"(focal_loss_bf16|focal_grad_bf16)ILi(\d+)ELi(\d+)"
                          r"ELi(\d+)ELb(\d)ELb(\d)E", name)
            if k:
                dregs["%s<%s>" % (k.group(1), ", ".join(k.groups()[1:]))] = \
                    int(m.group(1))
        if m and name and src in ("window_attention.cu", "upsample.cu"):
            k = re.search(r"(window_attn_bf16|window_attn_kernel|"
                          r"upsample2x_band|upsample2x_kernel)I(\w+?)EEv",
                          name)
            if k:
                args = re.sub(r"^f(?=L|$)", "float,", k.group(2))
                args = re.sub(r"13__nv_bfloat16", "bf16,", args)
                args = re.sub(r"L[ib](\d+)E", r"\1,", args)
                wregs["%s<%s>" % (k.group(1), args.rstrip(","))] = \
                    int(m.group(1))
        if m and name and src == "fine_stage.cu":
            k = re.search(
                r"(fine_stage_bf16|fine_stage_kernel)(?:ILi(\d+)E)?", name)
            short = (name if k is None else k.group(1) + (
                f"<{k.group(2)}>" if k.group(2) else ""))
            fregs[short] = int(m.group(1))
    return {"coarse_layer_registers": regs, "fine_stage_registers": fregs,
            "dual_softmax_bf16_registers": bregs,
            "sinkhorn_bf16_registers": eregs,
            "focal_bf16_registers": dregs,
            "window_upsample_registers": wregs, "spilling_kernels": spills}


def _strip_params(name):
    """A demangled function name without its parameter list."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0 and name[i] == "(":
            return name[:i]
    return name


def sass_start():
    """``cuobjdump -sass`` of each object of the loaded kernel library into
    ``<object>.sass`` beside it, one process a source, all started together
    (``sass_sizes`` waits for them and reads the files)."""
    from loftr_tpu_torch.ops.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    procs = {}
    for o in sorted(os.listdir(_build.build_dir)):
        if o.endswith(".o"):
            path = os.path.join(_build.build_dir, o)
            with open(path + ".sass", "w") as f:
                procs[o[:-2]] = (subprocess.Popen(
                    [tool, "-sass", path], stdout=f,
                    stderr=subprocess.DEVNULL), path + ".sass")
    return procs


def sass_sizes(procs):
    """{source: {kernel: bytes of SASS}} (16 bytes an instruction) from
    the processes of ``sass_start``; names demangled by ``cu++filt`` and
    shortened to the kernel and its template arguments."""
    import re
    from loftr_tpu_torch.ops.kernels import _build
    raw = {}
    for src, (p, path) in procs.items():
        p.wait(timeout=900)
        with open(path) as f:
            out = f.read()
        raw[src] = {}
        for part in re.split(r"\n\s*Function : ", out)[1:]:
            name, _, body = part.partition("\n")
            raw[src][name.strip()] = 16 * len(
                re.findall(r"^\s*/\*[0-9a-f]{4,}\*/", body, re.M))
    names = sorted({n for f in raw.values() for n in f})
    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    short = dict(zip(names, names))
    if os.path.exists(filt) and names:
        dem = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(dem) == len(names):
            short = {n: _strip_params(
                d.replace("(anonymous namespace)::", "")
                .replace("<unnamed>::", "").replace("loftr::", "")
                .replace("void ", "")) for n, d in zip(names, dem)}
    return {src: {short[n]: b for n, b in f.items()}
            for src, f in raw.items()}


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

def check_coarse(dev, log, w, name, x, s, xm, sm, phase=2):
    """Kernel A against its plain version on one case (numpy inputs; ``s``
    None for a self layer), in float32 and bfloat16.  Returns each dtype's
    max abs error; fails on a disagreement."""
    import torch
    from loftr_tpu_torch.ops.kernels import coarse_layer as KA
    f32, bf16 = torch.float32, torch.bfloat16
    # tolerances: float32 -- the bar of the JAX kernel's own tests
    # (2e-4, test_coarse_layer_fused.py), sums in another order; bfloat16 --
    # a different summation order can flip one bf16 rounding of an
    # intermediate (2^-8 relative), which the next product carries, so the
    # bar is a few output ulps at |y| ~ 4 with a small mean.
    tol = {f32: (2e-4, 2e-4, None), bf16: (0.125, 0.0, 5e-3)}
    err = {}
    for dt in (f32, bf16):
        xt = torch.from_numpy(x).to(dev, dt)
        st = xt if s is None else torch.from_numpy(s).to(dev, dt)
        xmt = None if xm is None else torch.from_numpy(xm).to(dev)
        smt = None if sm is None else torch.from_numpy(sm).to(dev)
        got = KA.fused_coarse_layer(xt, st, w, xmt, smt, 8)
        want = KA.coarse_layer_plain(xt, st, w, xmt, smt, 8)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        atol, rtol, mean_tol = tol[dt]
        ok = bool((d <= atol + rtol * want.float().abs()).all())
        if mean_tol is not None:
            ok = ok and float(d.mean()) <= mean_tol
        rec = {"phase": phase, "kernel": "coarse_layer", "case": name,
               "dtype": str(dt)[6:], "max_abs_err": float(d.max()),
               "mean_abs_err": float(d.mean()), "atol": atol,
               "rtol": rtol, "mean_tol": mean_tol, "ok": ok}
        emit(rec, log)
        check(ok, f"coarse_layer {name} {dt} disagrees: {rec}")
        err[dt] = float(d.max())
    return err


def check_dual(dev, log, name, x0, x1, mk0, mk1, phase=2):
    """Kernel B against its plain version on one case (numpy features and
    masks, or None), in float32 and bfloat16; an argmax or validity that
    differs must be a near-tie of the plain conf.  Returns each dtype's max
    abs error; fails on a disagreement."""
    import torch
    from loftr_tpu_torch.ops.kernels import dual_softmax as KB
    err = {}
    for dt in (torch.float32, torch.bfloat16):
        a = torch.from_numpy(x0).to(dev, dt)
        bb = torch.from_numpy(x1).to(dev, dt)
        m0 = None if mk0 is None else torch.from_numpy(mk0).to(dev)
        m1 = None if mk1 is None else torch.from_numpy(mk1).to(dev)
        bv, bj, cc = KB.fused_dual_softmax_match(a, bb, 0.1, m0, m1)
        pv, pj, pc = KB.dual_softmax_plain(a, bb, 0.1, m0, m1)
        # the plain conf, to explain argmax differences by near-ties
        B_, L_, C_ = a.shape
        S_ = bb.shape[1]
        sim = torch.matmul(a.float(), bb.float().transpose(1, 2))
        sim = sim / (C_ * 0.1)
        mm0 = torch.ones(B_, L_, device=dev) if m0 is None else m0.float()
        mm1 = torch.ones(B_, S_, device=dev) if m1 is None else m1.float()
        sim = sim + (mm0[:, :, None] * mm1[:, None, :] - 1.0) * 1e9
        conf = torch.softmax(sim, 2) * torch.softmax(sim, 1)
        del sim
        row_gap = rel_gap_top2(conf) if S_ > 1 else torch.ones_like(pv)
        col_gap = (rel_gap_top2(conf.transpose(1, 2)) if L_ > 1
                   else torch.ones_like(pc))
        del conf
        # valid as the epilogue forms it (thr 0.2, MNN), both versions
        vk = (bv > 0.2) & (bv >= torch.gather(cc, 1, bj.long()))
        vp = (pv > 0.2) & (pv >= torch.gather(pc, 1, pj.long()))
        torch.cuda.synchronize()
        j_diff = bj != pj
        v_diff = vk != vp
        near = (row_gap < 1e-6) | (torch.gather(
            col_gap, 1, pj.long()) < 1e-6)
        unexplained = int(((j_diff | v_diff) & ~near).sum())
        dv = float((bv - pv).abs().max())
        dc = float((cc - pc).abs().max())
        # tolerance: conf in [0, 1], float exps of sims that differ by
        # the summation order of a C=256 dot (the JAX test bar, 1e-4
        # relative; 1e-6 absolute for tiny values)
        okv = bool(((bv - pv).abs() <= 1e-6 + 1e-4 * pv.abs()).all())
        okc = bool(((cc - pc).abs() <= 1e-6 + 1e-4 * pc.abs()).all())
        rec = {"phase": phase, "kernel": "dual_softmax", "case": name,
               "shape": [B_, L_, S_, C_], "masked": mk0 is not None,
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
        err[dt] = max(dv, dc)
    return err


def check_fine(dev, log, l0, l1, w0, w1, phase=2):
    """Kernel C against its plain version on one set of window pairs
    (numpy [NB, 25, C]), in float32 and bfloat16.  Returns each dtype's max
    abs error; fails on a disagreement."""
    import torch
    from loftr_tpu_torch.ops.kernels import fine_stage as KC
    f32, bf16 = torch.float32, torch.bfloat16
    # float32: the JAX kernel test's bar (2e-4, test_fine_stage_fused.py);
    # bfloat16: the soft-argmax of features that may differ by one bf16
    # rounding flip, in window coordinates [-1, 1]
    tol = {f32: 2e-4, bf16: 5e-2}
    err = {}
    for dt in (f32, bf16):
        a = torch.from_numpy(w0).to(dev, dt)
        bb = torch.from_numpy(w1).to(dev, dt)
        got = KC.fused_fine_stage(a, bb, l0, l1, 8)
        want = KC.fine_stage_plain(a, bb, l0, l1, 8)
        torch.cuda.synchronize()
        d = (got - want).abs()
        ok = bool((d <= tol[dt] + tol[dt] * want.abs()).all())
        rec = {"phase": phase, "kernel": "fine_stage", "NB": len(w0),
               "dtype": str(dt)[6:], "max_abs_err": float(d.max()),
               "mean_abs_err": float(d.mean()), "atol": tol[dt],
               "rtol": tol[dt], "ok": ok}
        emit(rec, log)
        check(ok, f"fine_stage disagrees: {rec}")
        err[dt] = float(d.max())
    return err


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
    bf16 = torch.bfloat16

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
    # lengths that are no multiple of the 64-row source tile or of either
    # apply tile (48 rows at B=1, 80 at B=2), masked; their own generator,
    # so that the other kernels' inputs stay as they were
    rr = np.random.RandomState(1)
    for b in (1, 2):
        cases[f"ragged_B{b}_masked"] = (
            rr.randn(b, L - 100, C) * 0.5, rr.randn(b, L - 50, C) * 0.5,
            rr.rand(b, L - 100) > 0.2, rr.rand(b, L - 50) > 0.2)
    errA = {}
    for name, (x, s, xm, sm) in cases.items():
        for dt, e in check_coarse(dev, log, wA, name, x, s, xm, sm).items():
            errA[(name, dt)] = e
    # timing in bf16 at the main path's two launch shapes: the packed self
    # layers (x = src [2,4800,256]) and each cross direction ([1,4800,256]);
    # ms: CUDA events around back-to-back wrapper calls (host included),
    # device_ms: the profiler's kernel time per call
    packed = KC.pack_weights(wA, bf16)
    tA = {}
    for name in ("self_B2", "cross_B1"):
        xt = torch.from_numpy(cases[name][0]).to(dev, bf16)
        st = (xt if cases[name][1] is None
              else torch.from_numpy(cases[name][1]).to(dev, bf16))

        def run():
            return KA.fused_coarse_layer(xt, st, wA, None, None, 8,
                                         packed=packed)
        # per x row: q, merge, FFN (8 C^2 MACs), per-head KV apply and
        # normaliser; per source row: k, v (2 C^2) and the per-head KV
        # blocks.  Bytes: x, src and out once each, the weights once.
        rows = xt.shape[0] * L
        flops = 2 * (rows * (8 * C * C + C * (C // 8) + C)
                     + rows * (2 * C * C + C * (C // 8)))
        nbytes = 2 * rows * C * 2 + rows * C * 2 + 10 * C * C * 2 + 4 * C * 4
        b, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        rec = {"ms": cuda_ms(run, iters=20), "device_ms": device_ms(run),
               "plain_ms": cuda_ms(lambda: KA.coarse_layer_plain(
                   xt, st, wA, None, None, 8), iters=5),
               "bound_ms": b, "bound_by": by}
        emit({"phase": 2, "kernel": "coarse_layer", "timing": name, **rec},
             log)
        tA[name] = rec
    sB, cB = tA["self_B2"], tA["cross_B1"]
    results["coarse_layer"] = dict(
        max_abs_err=errA[("self_B2", bf16)], ms=sB["ms"],
        plain_ms=sB["plain_ms"], bound_ms=sB["bound_ms"],
        bound_by=sB["bound_by"], library_ms=None,
        bound_unit="bf16 tensor cores", shape="x=src [2,4800,256] bf16",
        device_ms=(sB["device_ms"] or {}).get("total"), ms_cross_B1=cB["ms"],
        device_ms_cross_B1=(cB["device_ms"] or {}).get("total"),
        plain_ms_cross_B1=cB["plain_ms"], bound_ms_cross_B1=cB["bound_ms"])

    # ---- kernel B: dual softmax, L=S=4800, C=256 -------------------------
    f0 = rng.randn(1, L, C).astype(np.float32)
    f1 = rng.randn(1, L, C).astype(np.float32)
    ii, jj = rng.permutation(L)[:400], rng.permutation(L)[:400]
    f1[0, jj] = f0[0, ii] + 0.1 * rng.randn(400, C)
    masks = (rng.rand(1, L) > 0.1, rng.rand(1, L) > 0.1)
    casesB = {"B1": (f0, f1, None, None),
              "B1_masked": (f0, f1, masks[0], masks[1])}
    # the B=8 forward's launch, a ragged pair (no multiple of any tile),
    # L=S=7, and the 840x840 coarse grid's S = 105*105; their own generator,
    # so that the other kernels' inputs stay as they were
    rb = np.random.RandomState(3)

    def pairB(B_, L_, S_, masked):
        a_ = rb.randn(B_, L_, C).astype(np.float32)
        b_ = rb.randn(B_, S_, C).astype(np.float32)
        n = min(L_, S_) // 12
        for k in range(B_):
            ia, ja = rb.permutation(L_)[:n], rb.permutation(S_)[:n]
            b_[k, ja] = a_[k, ia] + 0.1 * rb.randn(n, C)
        if not masked:
            return a_, b_, None, None
        return a_, b_, rb.rand(B_, L_) > 0.1, rb.rand(B_, S_) > 0.1
    casesB["B8_masked"] = pairB(8, L, L, True)
    casesB["ragged_B2_masked"] = pairB(2, L - 100, L - 50, True)
    casesB["L7_S7_masked"] = pairB(1, 7, 7, True)
    casesB["long_S11025"] = pairB(1, L, 105 * 105, False)
    errB = {}
    for name, (x0, x1, mk0, mk1) in casesB.items():
        for dt, e in check_dual(dev, log, name, x0, x1, mk0, mk1).items():
            errB[(name, dt)] = e
    # timing in bf16 at the main path's launches, B=1 (match_pair) and B=8
    # (the batched forward); ms: CUDA events around back-to-back wrapper
    # calls (host included), device_ms: the profiler's time per call (the
    # two passes dual_softmax_bf16<...> and the two combines), variant: the
    # pass kernel's name.  Bound: both passes' sim products (exponentials
    # not counted); features in, best value + index per row and column max
    # out.
    tB = {}
    for name in ("B1", "B8_masked"):
        x0, x1 = casesB[name][:2]
        a = torch.from_numpy(x0).to(dev, bf16)
        bb = torch.from_numpy(x1).to(dev, bf16)
        B_ = a.shape[0]

        def run():
            return KB.fused_dual_softmax_match(a, bb, 0.1)
        flops = 2 * 2 * B_ * L * L * C
        nbytes = B_ * (2 * L * C * 2 + L * 8 + L * 4)
        b, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        dms = device_ms(run) or {}
        kern = sorted(k for k in dms if "dual_softmax_bf16<" in k)
        rec = {"B": B_, "ms": cuda_ms(run, iters=20),
               "device_ms": dms.get("total"),
               "pass_device_ms": sum(dms[k] for k in kern),
               "variant": " ".join(kern) if len(kern) == 2 else None,
               "plain_ms": cuda_ms(lambda: KB.dual_softmax_plain(a, bb, 0.1),
                                   iters=5 if B_ == 1 else 2),
               "bound_ms": b, "bound_by": by}
        emit({"phase": 2, "kernel": "dual_softmax", "timing": f"B{B_}", **rec},
             log)
        check(not dms or rec["variant"] is not None,
              f"dual_softmax: not both bf16 passes in the profile: {dms}")
        tB[B_] = rec
    t1, t8 = tB[1], tB[8]
    results["dual_softmax"] = dict(
        max_abs_err=errB[("B1", bf16)], ms=t1["ms"], plain_ms=t1["plain_ms"],
        bound_ms=t1["bound_ms"], bound_by=t1["bound_by"], library_ms=None,
        bound_unit="bf16 tensor cores", shape="f0=f1 [1,4800,256] bf16",
        device_ms=t1["device_ms"], variant=t1["variant"], ms_B8=t8["ms"],
        device_ms_B8=t8["device_ms"], plain_ms_B8=t8["plain_ms"],
        bound_ms_B8=t8["bound_ms"])

    # ---- kernel C: fine stage, 25 x C=128 windows -----------------------
    # NB: the B=1 and B=8 forwards (1024, 8192 windows), the B=2 hybrid
    # training shape (1920), two counts that no pairs-per-block count (1-3)
    # divides (1021, 7), and one pair.  Every window is its own random
    # draw, so a leak across the boundary of two pairs packed in one block
    # shows.  Their own generator keeps the other kernels' inputs as they
    # were.
    Cf = 128
    l0, l1 = enc(Cf, 2), enc(Cf, 3)
    rc = np.random.RandomState(2)
    wins = {nb: (rc.randn(nb, 25, Cf) * 0.5, rc.randn(nb, 25, Cf) * 0.5)
            for nb in (1024, 8192, 1920, 1021, 7, 1)}
    errC = {}
    for nb, (w0, w1) in wins.items():
        for dt, e in check_fine(dev, log, l0, l1, w0, w1).items():
            errC[(nb, dt)] = e
    # timing in bf16 at the two forward shapes, with the weights packed
    # once as the model passes them (models/fused_fine.py); ms: CUDA events
    # around back-to-back wrapper calls (host included), device_ms: the
    # profiler's kernel time, variant: the launcher's instantiation
    # fine_stage_bf16<G> (G window pairs a block), read from the profiled
    # kernel's name
    packedC = (KC.pack_weights(l0, bf16), KC.pack_weights(l1, bf16))
    tC = {}
    for nb in (1024, 8192):
        a = torch.from_numpy(wins[nb][0]).to(dev, bf16)
        bb = torch.from_numpy(wins[nb][1]).to(dev, bf16)

        def run():
            return KC.fused_fine_stage(a, bb, l0, l1, 8, packed=packedC)
        # 4 encoder applications x 25 rows of 10 C^2 MACs, plus score-form
        # attention (25 scores and 25 taps per row), per window pair
        flops = nb * (2 * 100 * 10 * Cf * Cf + 2 * 2 * 100 * 25 * Cf)
        nbytes = 2 * nb * 25 * Cf * 2 + nb * 3 * 4 + 2 * 10 * Cf * Cf * 2
        b, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        dms = device_ms(run) or {}
        kern = [k for k in dms if k.startswith("fine_stage_bf16<")]
        rec = {"NB": nb, "ms": cuda_ms(run, iters=20),
               "device_ms": dms.get("total"),
               "variant": kern[0] if len(kern) == 1 else None,
               "plain_ms": cuda_ms(lambda: KC.fine_stage_plain(
                   a, bb, l0, l1, 8), iters=3),
               "bound_ms": b, "bound_by": by}
        emit({"phase": 2, "kernel": "fine_stage", "timing": f"NB{nb}", **rec},
             log)
        check(rec["variant"] is not None,
              f"fine_stage: no single bf16 kernel in the profile: {dms}")
        tC[nb] = rec
    t1, t8 = tC[1024], tC[8192]
    results["fine_stage"] = dict(
        max_abs_err=errC[(1024, bf16)], ms=t1["ms"], plain_ms=t1["plain_ms"],
        bound_ms=t1["bound_ms"], bound_by=t1["bound_by"], library_ms=None,
        bound_unit="bf16 tensor cores", shape="win0=win1 [1024,25,128] bf16",
        device_ms=t1["device_ms"], variant=t1["variant"], ms_8192=t8["ms"],
        device_ms_8192=t8["device_ms"], plain_ms_8192=t8["plain_ms"],
        bound_ms_8192=t8["bound_ms"], variant_8192=t8["variant"])
    for k, v in results.items():
        emit({"phase": 2, "kernel": k, "timing": v}, log)

def ot_case(rng, B, L, C, n_plant, S=None):
    """Features with a = 4 per channel: a planted correspondence has sim
    about 16 against N(0, 1) for unrelated cells, so its row and column beat
    the dustbin while the cells without a partner do not.  n_plant = L = S
    plants a full permutation (no cell prefers the dustbin).  S defaults to
    L."""
    import numpy as np
    S = L if S is None else S
    f0 = (rng.randn(B, L, C) * 4).astype(np.float32)
    f1 = (rng.randn(B, S, C) * 4).astype(np.float32)
    for b in range(B):
        ii, jj = rng.permutation(L)[:n_plant], rng.permutation(S)[:n_plant]
        f1[b, jj] = f0[b, ii] + 0.4 * rng.randn(len(ii), C).astype(np.float32)
    return f0, f1


def new_kernel_checks(dev, log, results):
    """Kernel E (Sinkhorn) against its plain version on the card."""
    import numpy as np
    import torch
    from loftr_tpu_torch.ops.kernels import sinkhorn as KE

    rng = np.random.RandomState(11)
    f32, bf16 = torch.float32, torch.bfloat16
    C, L = 256, (H // 8) * (W // 8)

    # ---- kernel E: Sinkhorn, B=2, L=S=4800, C=256, 3 iterations ----------
    B = 2
    masks = (rng.rand(B, L) > 0.1, rng.rand(B, L) > 0.1)
    # "partial": 1500 planted pairs, the other cells prefer the dustbin, so
    # the prefilter fires; "full": a planted permutation, it does not.  The
    # dustbin's potential absorbs bin_score, so which cells are flagged
    # follows the features' contrast; the two scores are those of the JAX
    # package's test.
    data = {"partial": (ot_case(rng, B, L, C, 1500), 1.5),
            "full": (ot_case(rng, B, L, C, L), 0.5)}
    errE = {}

    def caseE(name, f0, f1, mk0, mk1, bin_score, prefilter):
        """Both dtypes of one case against sinkhorn_plain, at the bars
        below; returns {dtype: max abs error}."""
        alpha = torch.tensor(bin_score, device=dev)
        errs = {}
        for dt in (f32, bf16):
            a = torch.from_numpy(f0).to(dev, dt)
            b = torch.from_numpy(f1).to(dev, dt)
            m0 = None if mk0 is None else torch.from_numpy(mk0).to(dev)
            m1 = None if mk1 is None else torch.from_numpy(mk1).to(dev)
            kv, kj, kc, k0, k1 = KE.fused_sinkhorn_match(
                a, b, alpha, 3, m0, m1, prefilter=prefilter)
            pv, pj, pc, p0, p1, conf, mar0, mar1 = KE.sinkhorn_plain(
                a, b, alpha, 3, m0, m1, prefilter=prefilter, with_conf=True)
            torch.cuda.synchronize()
            # near ties: a flag whose margin is within float rounding of 0
            # (the logits are of size 20: 1e-5), a best column whose two
            # largest conf values differ by less than 1e-5 relative, and
            # (with prefilter) a row or column touched by a near-tie flag
            tie0, tie1 = mar0.abs() < 1e-5, mar1.abs() < 1e-5
            f_bad = int(((k0 != p0) & ~tie0).sum() + ((k1 != p1) & ~tie1).sum())
            near = rel_gap_top2(conf) < 1e-5
            if prefilter:
                near |= tie0 | (tie1.any(dim=1, keepdim=True))
            j_diff = kj != pj
            j_bad = int((j_diff & ~near).sum())
            col_near = rel_gap_top2(conf.transpose(1, 2)) < 1e-5
            vk = (kv > 0.2) & (kv >= torch.gather(kc, 1, kj.long()))
            vp = (pv > 0.2) & (pv >= torch.gather(pc, 1, pj.long()))
            v_bad = int(((vk != vp) & ~near
                         & ~torch.gather(col_near, 1, pj.long())).sum())
            del conf
            # tolerance: conf in [0, 1] from float logits of size 20 whose
            # C=256 dots and log-sum-exps run in another order (the JAX
            # test's bars: 1e-4 relative, 1e-6 absolute); rows and columns
            # touched by a near-tie flag are left out under prefilter
            keep_r = ~(tie0 | tie1.any(dim=1, keepdim=True)) if prefilter \
                else torch.ones_like(tie0)
            keep_c = ~(tie1 | tie0.any(dim=1, keepdim=True)) if prefilter \
                else torch.ones_like(tie1)
            okv = bool((((kv - pv).abs() <= 1e-6 + 1e-4 * pv.abs())
                        | ~keep_r).all())
            okc = bool((((kc - pc).abs() <= 1e-6 + 1e-4 * pc.abs())
                        | ~keep_c).all())
            dv = float(((kv - pv).abs() * keep_r).max())
            dc = float(((kc - pc).abs() * keep_c).max())
            rec = {"phase": 2, "kernel": "sinkhorn", "case": name,
                   "shape": [*a.shape[:2], b.shape[1], C],
                   "bin_score": bin_score, "masked": mk0 is not None,
                   "prefilter": prefilter, "batch": a.shape[0],
                   "dtype": str(dt)[6:],
                   "best_val_max_abs_err": dv, "colconf_max_abs_err": dc,
                   "best_j_mismatch": int(j_diff.sum()),
                   "flag_mismatch": int((k0 != p0).sum() + (k1 != p1).sum()),
                   "near_tie_rows": int(near.sum()),
                   "near_tie_flags": int(tie0.sum() + tie1.sum()),
                   "unexplained_mismatch": j_bad + f_bad + v_bad,
                   "rows_flagged": int(p0.sum()), "cols_flagged": int(p1.sum()),
                   "n_valid": int(vk.sum()),
                   "ok": okv and okc and j_bad + f_bad + v_bad == 0}
            emit(rec, log)
            check(rec["ok"], f"sinkhorn disagrees: {rec}")
            errs[dt] = max(dv, dc)
            del pv, pj, pc, p0, p1, mar0, mar1
        return errs

    # B=2 holds the per-pair offsets; B=1 is match_pair's own shape, where
    # the column chunks are cut differently (the chunk count follows B)
    for name, masked, prefilter, nb in (("partial", False, False, B),
                                        ("partial", False, True, B),
                                        ("partial", True, True, B),
                                        ("full", False, True, B),
                                        ("full", True, False, B),
                                        ("partial", False, False, 1),
                                        ("partial", True, True, 1)):
        (f0, f1), bin_score = data[name]
        errs = caseE(name, f0[:nb], f1[:nb],
                     masks[0][:nb] if masked else None,
                     masks[1][:nb] if masked else None, bin_score, prefilter)
        errE[(name, masked, prefilter, nb)] = errs[bf16]
    # ragged shapes, no multiple of a tile, and the two orientations' plans
    # cut differently (L=4800 with S=1200 and its mirror); their own
    # generator, so that the other kernels' inputs stay as they were
    re_ = np.random.RandomState(5)
    for name, B_, L_, S_, masked, prefilter in (
            ("ragged_B2", 2, L - 100, L - 50, True, True),
            ("L7_S7", 1, 7, 7, True, True),
            ("L4800_S1200", 1, L, L // 4, False, False),
            ("L1200_S4800", 1, L // 4, L, True, True)):
        f0, f1 = ot_case(re_, B_, L_, C, min(L_, S_) * 3 // 10, S_)
        mk = (re_.rand(B_, L_) > 0.1, re_.rand(B_, S_) > 0.1) if masked \
            else (None, None)
        caseE(name, f0, f1, *mk, 1.5, prefilter)
    # what the bf16 path does not take raises, with no fallback: C != 256,
    # and features 2 bytes off the 16-byte alignment
    alpha = torch.tensor(1.5, device=dev)
    narrow = torch.zeros((1, 7, 128), device=dev, dtype=bf16)
    shifted = torch.zeros(7 * C + 1, device=dev, dtype=bf16)[1:].view(1, 7, C)
    for x in (narrow, shifted):
        try:
            KE.fused_sinkhorn_match(x, x, alpha, 3)
            check(False, f"sinkhorn took bf16 {tuple(x.shape)} at offset "
                  f"{x.data_ptr() % 16}")
        except ValueError:
            pass
    # timing in bf16 at match_pair's launch (B=1) and the B=8 forward's,
    # "partial" features, 3 iterations, prefilter off (the presets'
    # default) and on: ms by CUDA events around back-to-back wrapper calls
    # (host included), device_ms the profiler's time per call (every pass
    # and combine), variant the pass kernels' profiled names.  Bound: the
    # least work, one sim product per iteration and one for the final pass
    # (one more with prefilter); features in, per-row best value + index +
    # flag and per-column max + flag out.
    (f0, f1), bin_score = data["partial"]
    f8 = ot_case(re_, 8, L, C, 1500)
    # the B=8 forward's launch (8x the blocks of B=1), held to the bars
    # above as timed (unmasked, prefilter off) and masked with prefilter
    mk8 = (re_.rand(8, L) > 0.1, re_.rand(8, L) > 0.1)
    caseE("B8", *f8, None, None, bin_score, False)
    caseE("B8", *f8, *mk8, bin_score, True)
    alpha = torch.tensor(bin_score, device=dev)
    tE = {}
    for nb, (x0, x1) in ((1, (f0[:1], f1[:1])), (8, f8)):
        a = torch.from_numpy(x0).to(dev, bf16)
        b = torch.from_numpy(x1).to(dev, bf16)
        rec = {"B": nb}
        for pf in (False, True):
            def run():
                return KE.fused_sinkhorn_match(a, b, alpha, 3, prefilter=pf)
            dms = device_ms(run) or {}
            kern = sorted(k for k in dms if "sinkhorn_bf16<" in k)
            sfx = "_prefilter" if pf else ""
            rec["ms" + sfx] = cuda_ms(run, iters=20)
            rec["device_ms" + sfx] = dms.get("total")
            rec["pass_device_ms" + sfx] = sum(dms[k] for k in kern)
            rec["variant" + sfx] = " ".join(kern) if kern else None
            check(not dms or kern, f"sinkhorn: no bf16 pass in the profile: "
                  f"{dms}")
            flops = (3 + 1 + pf) * 2 * nb * L * L * C
            nbytes = nb * (2 * L * C * 2 + L * 9 + L * 5)
            rec["bound_ms" + sfx], rec["bound_by"] = bound_ms(
                flops, nbytes, PEAK_BF16_FLOPS)
        rec["plain_ms"] = cuda_ms(lambda: KE.sinkhorn_plain(a, b, alpha, 3),
                                  iters=5 if nb == 1 else 2)
        emit({"phase": 2, "kernel": "sinkhorn", "timing": f"B{nb}", **rec},
             log)
        tE[nb] = rec
        del a, b
    t1, t8 = tE[1], tE[8]
    results["sinkhorn"] = dict(
        max_abs_err=errE[("partial", False, False, 1)], ms=t1["ms"],
        plain_ms=t1["plain_ms"], bound_ms=t1["bound_ms"],
        bound_by=t1["bound_by"], library_ms=None,
        bound_unit="bf16 tensor cores", device_ms=t1["device_ms"],
        variant=t1["variant"], ms_prefilter=t1["ms_prefilter"],
        device_ms_prefilter=t1["device_ms_prefilter"],
        bound_ms_prefilter=t1["bound_ms_prefilter"], ms_B8=t8["ms"],
        device_ms_B8=t8["device_ms"], plain_ms_B8=t8["plain_ms"],
        bound_ms_B8=t8["bound_ms"], ms_B8_prefilter=t8["ms_prefilter"],
        device_ms_B8_prefilter=t8["device_ms_prefilter"],
        shape="f0=f1 [1,4800,256] bf16, 3 iterations (checked there, at "
              "[2,4800,256], [8,4800,256] and at four ragged shapes)")

    emit({"phase": 2, "kernel": "sinkhorn", "timing": results["sinkhorn"]},
         log)


def window_upsample_checks(dev, log, results):
    """Kernels F (window attention) and G (upsample) against their plain
    versions on the card, and their times at the main path's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from loftr_tpu_torch.ops.kernels import upsample as KG
    from loftr_tpu_torch.ops.kernels import window_attention as KF

    rng = np.random.RandomState(12)
    f32, bf16 = torch.float32, torch.bfloat16

    # ---- kernel F: window attention, 25 x 128, 8 heads ---------------------
    # tolerances: float32 -- sums in another order (2e-4, the JAX test's
    # bar); bfloat16 -- the same rounding points in both versions, so one
    # output ulp (2^-8 relative) plus what one flipped score rounding moves
    tolF = {f32: (2e-4, 2e-4), bf16: (2e-3, 2 ** -7)}
    errF = {}
    # the fine stack's two launch shapes, ragged window counts (the bf16
    # path walks windows a block grid-stride), and one shape that takes the
    # general version (3 x 3 windows, 2 heads of 32)
    for NB, w2, c, h in ((2048, 25, 128, 8), (1024, 25, 128, 8),
                         (1021, 25, 128, 8), (7, 25, 128, 8),
                         (1, 25, 128, 8), (64, 9, 64, 2)):
        q, k, v = (rng.randn(NB, w2, c).astype(np.float32) for _ in range(3))
        for dt in (f32, bf16):
            tq, tk, tv = (torch.from_numpy(x).to(dev, dt) for x in (q, k, v))
            got = KF.window_linear_attention(tq, tk, tv, h).float()
            want = KF.window_attention_plain(tq, tk, tv, h).float()
            torch.cuda.synchronize()
            d = (got - want).abs()
            atol, rtol = tolF[dt]
            ok = bool((d <= atol + rtol * want.abs()).all())
            rec = {"phase": 2, "kernel": "window_attention",
                   "shape": [NB, w2, c], "heads": h,
                   "dtype": str(dt)[6:], "max_abs_err": float(d.max()),
                   "mean_abs_err": float(d.mean()),
                   "exactly_equal_share": float((d == 0).float().mean()),
                   "atol": atol, "rtol": rtol, "ok": ok}
            emit(rec, log)
            check(ok, f"window_attention disagrees: {rec}")
            errF[(NB, dt)] = float(d.max())
    timesF = {}
    for NB in (2048, 1024):
        tq, tk, tv = (torch.from_numpy(
            rng.randn(NB, 25, 128).astype(np.float32)).to(dev, bf16)
            for _ in range(3))

        def run():
            return KF.window_linear_attention(tq, tk, tv, 8)
        dms = device_ms(run) or {}
        timesF[NB] = dict(
            ms=cuda_ms(run, iters=20), device_ms=dms.get("total"),
            variant=sorted(k for k in dms if k != "total"),
            plain_ms=cuda_ms(lambda: KF.window_attention_plain(tq, tk, tv, 8),
                             iters=5))

    def f_bound(NB):    # q, k, v read once, out written once
        return bound_ms(NB * 2 * 2 * 25 * 25 * 128, 4 * NB * 25 * 128 * 2,
                        PEAK_BF16_FLOPS)
    bnd, by = f_bound(2048)
    t, t1 = timesF[2048], timesF[1024]
    results["window_attention"] = dict(
        max_abs_err=errF[(2048, bf16)], ms=t["ms"], device_ms=t["device_ms"],
        variant=t["variant"], plain_ms=t["plain_ms"], bound_ms=bnd,
        bound_by=by, library_ms=None, bound_unit="device memory",
        ms_1024_windows=t1["ms"], device_ms_1024_windows=t1["device_ms"],
        plain_ms_1024_windows=t1["plain_ms"],
        bound_ms_1024_windows=f_bound(1024)[0],
        shape="q=k=v [2048,25,128] bf16, 8 heads (checked there, at 1024, "
              "1021, 7 and 1 windows and at [64,9,64] with 2 heads)")

    # ---- kernel G: x2 upsample at the backbone's two sites, B=1 pair -----
    # tolerances: float32 -- two-term float sums, fused or not (1e-6);
    # bfloat16 -- both versions round the same float sums of exact
    # products: one ulp.  The plain version runs on the CPU copy of the
    # inputs, where its matrix products sum in float32; on the card
    # cuBLAS may reduce a bf16 product in bf16, which moves an output by
    # more than its own ulp where the two taps cancel (its distance to the
    # kernel is reported beside)
    tolG = {f32: (1e-6, 1e-6), bf16: (1e-6, 2 ** -7)}
    errG, timesG = {}, {}
    small, big = (2, 256, H // 8, W // 8), (2, 196, H // 4, W // 4)
    # the two sites, then rows the band path takes on its scalar path
    # (widths 7 and 9, one input row) and a ragged last band (2H = 14)
    for shp in (small, big, (1, 3, 5, 7), (1, 4, 1, 9), (2, 8, 7, 80)):
        x = rng.randn(*shp).astype(np.float32)
        for dt in (f32, bf16):
            xt = torch.from_numpy(x).to(dev, dt)
            got = KG.upsample2x(xt).float()
            card = KG.upsample2x_plain(xt).float()
            lib = F.interpolate(xt, scale_factor=2, mode="bilinear",
                                align_corners=True).float()
            torch.cuda.synchronize()
            want = KG.upsample2x_plain(xt.cpu()).float().to(dev)
            d = (got - want).abs()
            atol, rtol = tolG[dt]
            ok = bool((d <= atol + rtol * want.abs()).all()) \
                and got.shape == (shp[0], shp[1], 2 * shp[2], 2 * shp[3])
            rec = {"phase": 2, "kernel": "upsample", "shape": list(shp),
                   "dtype": str(dt)[6:], "max_abs_err": float(d.max()),
                   "exactly_equal_share": float((d == 0).float().mean()),
                   "max_abs_diff_from_plain_on_card":
                       float((got - card).abs().max()),
                   "plain_on_card_unequal":
                       int((card != want).sum()),
                   "max_abs_diff_from_F_interpolate":
                       float((got - lib).abs().max()),
                   "atol": atol, "rtol": rtol, "ok": ok}
            emit(rec, log)
            check(ok, f"upsample disagrees: {rec}")
            errG[(shp, dt)] = float(d.max())
        if shp in (small, big):
            xt = torch.from_numpy(x).to(dev, bf16)

            def run():
                return KG.upsample2x(xt)
            dms = device_ms(run) or {}
            timesG[shp] = dict(
                ms=cuda_ms(run, iters=20), device_ms=dms.get("total"),
                variant=sorted(k for k in dms if k != "total"),
                plain_ms=cuda_ms(lambda: KG.upsample2x_plain(xt), iters=10),
                library_ms=cuda_ms(lambda: F.interpolate(
                    xt, scale_factor=2, mode="bilinear", align_corners=True),
                    iters=20))

    def g_bound(shp):   # input once, output (4x) once; 8 flop an output
        n = shp[0] * shp[1] * shp[2] * shp[3]
        return bound_ms(4 * n * 8, 5 * n * 2, PEAK_F32_FLOPS)
    bnd, by = g_bound(big)
    t, t1 = timesG[big], timesG[small]
    results["upsample"] = dict(
        max_abs_err=errG[(big, bf16)], ms=t["ms"], device_ms=t["device_ms"],
        variant=t["variant"], plain_ms=t["plain_ms"], bound_ms=bnd,
        bound_by=by, library_ms=t["library_ms"], bound_unit="device memory",
        library="torch.nn.functional.interpolate(scale_factor=2, "
                "mode='bilinear', align_corners=True)",
        ms_small=t1["ms"], device_ms_small=t1["device_ms"],
        plain_ms_small=t1["plain_ms"], library_ms_small=t1["library_ms"],
        bound_ms_small=g_bound(small)[0],
        shape="x [2,196,120,160] bf16 (small: [2,256,60,80]; checked there "
              "and at [1,3,5,7], [1,4,1,9], [2,8,7,80])")
    for k in ("window_attention", "upsample"):
        emit({"phase": 2, "kernel": k, "timing": results[k]}, log)


def focal_case(rng, B, L, C, n_gt, S=None, n_alike=1500, cells=None):
    """Features at a scale where the confidences of interest lie inside the
    clamp (1e-6, 1 - 1e-6): 2 n planted pairs in each image pair (sim about
    6 at any C, against N(0, 0.4) for the rest at C = 256), n = n_alike or
    fewer where L or S is small; the first n_gt[b] of them are the ground
    truth of pair b, the others look-alikes, so that negatives with a live
    gradient exist (an unrelated cell's confidence, about 4e-8, is
    clamped).  ``cells``, (indices into L, indices into S), plants only
    there (a padding mask's valid cells).  f0 [B, L, C], f1 [B, S, C]."""
    import numpy as np
    S = L if S is None else S
    n_gt = [n_gt] * B if isinstance(n_gt, int) else list(n_gt)
    f0 = (rng.randn(B, L, C) * 0.77).astype(np.float32)
    f1 = (rng.randn(B, S, C) * 0.77).astype(np.float32)
    gt_j = np.zeros((B, L), np.int32)
    gt_valid = np.zeros((B, L), bool)
    c0, c1 = (np.arange(L), np.arange(S)) if cells is None else cells
    n = min(n_alike, len(c0) // 2, len(c1) // 2)
    for b in range(B):
        ii, jj = rng.permutation(c0)[:2 * n], rng.permutation(c1)[:2 * n]
        f1[b, jj] = f0[b, ii] + 0.1 * rng.randn(2 * n, C).astype(np.float32)
        k = min(n_gt[b], n)
        gt_j[b, ii[:k]] = jj[:k]
        gt_valid[b, ii[:k]] = True
    return f0, f1, gt_j, gt_valid


# kernel D's profiled kernels by name (chip_smoke.device_ms): its own, on
# both paths, and the statistics pass it shares with kernel B's bf16 path
FOCAL_KERNELS = ("focal_prescale", "bf::focal_loss_bf16", "bf::loss_combine",
                 "bf::focal_grad_bf16", "bf::grad_combine",
                 "focal_tile_kernel", "focal_grad_kernel",
                 "scalar_combine_kernel", "sum_combine_kernel")
STATS_KERNELS = ("bf::dual_softmax_bf16<4, 8, 2, 0>", "bf::stats_combine")
# the profiler's names of kernel D's autograd Function, forward and backward
FOCAL_OPS = ("_FocalSums", "_FocalSumsBackward")


def focal_device_ms(dms):
    """Kernel D's device ms from a ``device_ms`` dict of a call that runs
    kernel D alone: its own kernels plus kernel B's pass 1 and
    ``stats_combine``, which give its statistics."""
    if not dms:
        return None
    return sum(v for k, v in dms.items() if k != "total"
               and k.startswith(FOCAL_KERNELS + STATS_KERNELS))


def focal_timing(dev, rng, B, fns):
    """Events ms and profiled device ms, forward (no graph) and forward +
    backward, of each wrapper in ``fns`` at bf16 [B, 4800, 256]."""
    import torch
    L, C = (H // 8) * (W // 8), 256
    f0, f1, gt_j, gt_valid = focal_case(rng, B, L, C, 1500)
    a = torch.from_numpy(f0).to(dev, torch.bfloat16).requires_grad_(True)
    b = torch.from_numpy(f1).to(dev, torch.bfloat16).requires_grad_(True)
    gj = torch.from_numpy(gt_j).to(dev)
    gv = torch.from_numpy(gt_valid).to(dev)
    out = {}
    for which, fn, iters in fns:
        def fwd():
            with torch.no_grad():
                return fn(a, b, gj, gv)

        def fwd_bwd():
            p, n = fn(a, b, gj, gv)
            torch.autograd.grad(p.sum() + n.sum(), (a, b))
        rec = {"ms_forward": cuda_ms(fwd, iters=iters),
               "ms": cuda_ms(fwd_bwd, iters=iters)}
        rec["ms_backward"] = rec["ms"] - rec["ms_forward"]
        if which == "kernel":
            df, dfb = device_ms(fwd), device_ms(fwd_bwd)
            rec["device_ms_forward"] = focal_device_ms(df)
            rec["device_ms"] = focal_device_ms(dfb)
            if None not in (df, dfb):
                rec["device_ms_backward"] = (rec["device_ms"]
                                             - rec["device_ms_forward"])
                rec["kernels_forward_backward"] = dfb
            # the same, as the training step's figure is read: every kernel
            # launched inside kernel D's forward and backward
            rng_ms = range_device_ms(fwd_bwd, FOCAL_OPS)
            rec["range_device_ms"] = rng_ms and rng_ms["total"]
            rec["range_kernels"] = rng_ms
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_bwd()
        torch.cuda.synchronize()
        rec["peak_mem_MiB"] = (torch.cuda.max_memory_allocated()
                               - base) / 2 ** 20
        out[which] = rec
    return out


def focal_bounds(B, L, S, C):
    """Kernel D's bounds (ms) at [B, L, S, C], bf16: (bound: the 5
    products of 2LSC the function needs -- the statistics' and the loss's
    sim, the backward's one sim and its two gradient products; this
    design's 6, each gradient grid forming its own sim; the earlier tile
    kernels' count, 7 products, all bf16; the same count with the 2
    gradient products at the float32 rate; bytes' time)."""
    prod = 2.0 * B * L * S * C
    t_bytes = B * (2 * (L + S) * C * 2) / PEAK_BYTES * 1e3
    return (5 * prod / PEAK_BF16_FLOPS * 1e3,
            6 * prod / PEAK_BF16_FLOPS * 1e3,
            7 * prod / PEAK_BF16_FLOPS * 1e3,
            (5 * prod / PEAK_BF16_FLOPS + 2 * prod / PEAK_F32_FLOPS) * 1e3,
            t_bytes)


def check_focal(dev, log, name, f0, f1, gt_j, gt_valid, m0, m1,
                gamma=2.0, grad=True, phase=2):
    """Kernel D (``fused_focal_sums``) against ``focal_sums_plain`` on the
    same inputs, forward and (with ``grad``) backward under two cotangents,
    in float32 and bf16.  f0 [B, L, C], f1 [B, S, C] float32, gt_j and
    gt_valid [B, L], masks m0 [B, L] and m1 [B, S] bool or None: numpy.
    Returns {dtype: the largest gradient error under the loss's cotangent}
    (empty without ``grad``)."""
    import numpy as np
    import torch
    from loftr_tpu_torch.ops.kernels import focal_loss as KD

    f32, bf16 = torch.float32, torch.bfloat16
    B, L, C = f0.shape
    S = f1.shape[1]
    # tolerances.  Sums: the kernel adds L x S float terms (23 million at
    # 4800^2) in another order than torch.sum, and a term near conf = 1
    # carries log1p(-c) with the float rounding of c: 2e-4 relative.
    # Gradients, float32: 1e-3 of the entry (the bar of the JAX kernels
    # against jax.grad) plus 1e-3 of the largest entry of that pair's
    # gradient (sums of S float products in another order).  bfloat16:
    # both versions round the float gradient to bfloat16 at the end, so
    # entries may differ by one ulp (2^-8).
    tol_sum = 2e-4
    tol_grad = {f32: (1e-3, 1e-3), bf16: (8e-3, 2e-3)}
    errs = {}
    gj = torch.from_numpy(gt_j).to(dev)
    gv = torch.from_numpy(gt_valid).to(dev)
    masked = m0 is not None
    if masked:
        m0, m1 = torch.from_numpy(m0).to(dev), torch.from_numpy(m1).to(dev)
    count = gt_valid.sum(1)
    # cotangents, one pair of them per image pair: the loss's own
    # (1/n_pos, 1/n_neg), where the positives dominate, scaled apart
    # between the pairs; and the negatives alone
    sc = torch.arange(1, B + 1, dtype=torch.float32, device=dev)
    c_pos = (1.5 - 0.5 * sc) / torch.from_numpy(
        np.maximum(count, 1)).to(dev)
    c_neg = sc / torch.from_numpy(L * S - count).to(dev)
    c_neg_only = 2.0 * sc - 1.0
    has_pos = torch.from_numpy(count > 0).to(dev)
    for dt in (f32, bf16):
        out = {}
        for which, fn in (("kernel", KD.fused_focal_sums),
                          ("plain", KD.focal_sums_plain)):
            a = torch.from_numpy(f0).to(dev, dt).requires_grad_(grad)
            b = torch.from_numpy(f1).to(dev, dt).requires_grad_(grad)
            n0 = KD.fused_focal_sums.launches
            with torch.set_grad_enabled(grad):
                p, n = fn(a, b, gj, gv, m0, m1, 0.1, 0.25, gamma)
            if which == "kernel":
                check(KD.fused_focal_sums.launches == n0 + 1
                      and p.requires_grad == grad,
                      f"focal_loss {name}: not one kernel call")
            if not grad:
                out[which] = (p, n, None, None)
                continue
            g_loss = torch.autograd.grad(
                (p * c_pos).sum() + (n * c_neg).sum(), (a, b),
                retain_graph=True)
            g_neg = torch.autograd.grad((n * c_neg_only).sum(), (a, b))
            # [2B, L, C]: per image pair, the loss's gradient, then
            # the negatives-only gradient
            out[which] = (p.detach(), n.detach(),
                          torch.cat([g_loss[0], g_neg[0]]),
                          torch.cat([g_loss[1], g_neg[1]]))
            del a, b, p, n, g_loss, g_neg
        torch.cuda.synchronize()
        (kp, kn, ka, kb), (pp, pn, pa, pb) = out["kernel"], out["plain"]

        def rel(x, y):    # per image pair, the worst
            return float(((x - y).abs() / y.abs().clamp_min(1e-30)).max())
        rtol, ftol = tol_grad[dt]

        def grad_ok(x, y):
            # each pair's gradient under each cotangent against its
            # own largest entry
            return all(bool(((u - v).abs() <= rtol * v.abs()
                             + ftol * v.abs().max()).all())
                       for u, v in zip(x.float(), y.float()))

        def gerr(x, y, sl):
            return float((x.float() - y.float())[sl].abs().max())
        pos_err = rel(kp[has_pos], pp[has_pos]) if bool(has_pos.any()) \
            else 0.0
        ok = (rel(kn, pn) <= tol_sum and pos_err <= tol_sum
              and bool((kp[~has_pos] == 0).all())
              and bool((pp[~has_pos] == 0).all()))
        rec = {"phase": phase, "kernel": "focal_loss", "case": name,
               "batch": B, "L": L, "S": S, "C": C, "gamma": gamma,
               "masked": masked, "gradient": grad,
               "n_gt": count.tolist(),
               "dtype": str(dt)[6:], "pos": kp.tolist(),
               "neg": kn.tolist(), "pos_rel_err": pos_err,
               "neg_rel_err": rel(kn, pn), "sum_rtol": tol_sum}
        if grad:
            ok = (ok and grad_ok(ka, pa) and grad_ok(kb, pb)
                  and bool(torch.isfinite(ka.float()).all())
                  and bool(torch.isfinite(kb.float()).all()))
            lo, hi = slice(0, B), slice(B, 2 * B)
            rec.update({
                "dfeat0_max_abs_err": gerr(ka, pa, lo),
                "dfeat0_max_abs": float(pa.float()[lo].abs().max()),
                "dfeat1_max_abs_err": gerr(kb, pb, lo),
                "dfeat1_max_abs": float(pb.float()[lo].abs().max()),
                "neg_only_dfeat0_max_abs_err": gerr(ka, pa, hi),
                "neg_only_dfeat0_max_abs": float(
                    pa.float()[hi].abs().max()),
                "neg_only_dfeat1_max_abs_err": gerr(kb, pb, hi),
                "neg_only_dfeat1_max_abs": float(
                    pb.float()[hi].abs().max()),
                "grad_rtol": rtol, "grad_tol_of_max": ftol})
            errs[dt] = max(rec["dfeat0_max_abs_err"],
                           rec["dfeat1_max_abs_err"])
        rec["ok"] = ok
        emit(rec, log)
        check(ok, f"focal_loss {name} {dt} disagrees: {rec}")
        del out, ka, kb, pa, pb
    return errs


def train_kernel_checks(dev, log, results):
    """Kernel D (focal loss, forward and backward) and the hybrid fine
    stage's backward, against their plain versions on the card."""
    import numpy as np
    import torch
    from loftr_tpu_torch.models.fused_fine import encoder_weights
    from loftr_tpu_torch.models.transformer import LoFTREncoderLayer
    from loftr_tpu_torch.ops.fine_stage_hybrid import fused_fine_stage_hybrid
    from loftr_tpu_torch.ops.kernels import fine_stage as KC
    from loftr_tpu_torch.ops.kernels import focal_loss as KD
    from loftr_tpu_torch.utils.weights import init_weights

    rng = np.random.RandomState(7)
    f32, bf16 = torch.float32, torch.bfloat16
    L0 = (H // 8) * (W // 8)
    errD = {}
    # (name, B, L, S, C, planted ground truth per pair, masked, gamma,
    # gradient).  The first four at B=2, the training main path's batch,
    # with another ground truth, mask and cotangent in each pair, so that
    # every per-pair offset in the kernels is held against the plain
    # version; then ragged and rectangular shapes (the two gradient grids'
    # plans differ), gamma != 2, C = 128 (bf16 on the tile path, with the
    # prescaled copies) and a forward without a graph.
    cases = (("plain", 2, L0, L0, 256, (1500, 900), False, 2.0, True),
             ("masked", 2, L0, L0, 256, (1500, 900), True, 2.0, True),
             ("no_positives", 2, L0, L0, 256, (0, 0), False, 2.0, True),
             ("one_pair_without_positives", 2, L0, L0, 256, (0, 1500), False,
              2.0, True),
             ("ragged_masked", 2, 4700, 4750, 256, (1500, 900), True, 2.0,
              True),
             ("tiny", 1, 7, 7, 256, (2,), False, 2.0, True),
             ("L4800_S1200", 1, L0, 1200, 256, (600,), False, 2.0, True),
             ("L1200_S4800", 1, 1200, L0, 256, (600,), False, 2.0, True),
             ("gamma_1.5", 2, L0, L0, 256, (1500, 900), True, 1.5, True),
             ("C128", 2, L0, L0, 128, (1500, 900), False, 2.0, True),
             ("no_grad", 2, L0, L0, 256, (1500, 900), True, 2.0, False))
    for name, B, L, S, C, n_gt, masked, gamma, grad in cases:
        f0, f1, gt_j, gt_valid = focal_case(rng, B, L, C, n_gt, S)
        m0 = rng.rand(B, L) > 0.1 if masked else None
        m1 = rng.rand(B, S) > 0.1 if masked else None
        for dt, err in check_focal(dev, log, name, f0, f1, gt_j, gt_valid,
                                   m0, m1, gamma, grad).items():
            errD[(name, dt)] = err

    # timing (events and profiled device time) and peak memory, bf16, at
    # B=1 (one pair) and B=2 (the training batch)
    t = {B: focal_timing(dev, rng, B, (
        ("kernel", KD.fused_focal_sums, 10),
        ("plain", KD.focal_sums_plain, 5))) for B in (1, 2)}
    k1, p1, k2 = t[1]["kernel"], t[1]["plain"], t[2]["kernel"]
    (bound, two_grid, all_bf16, f32_products,
     t_bytes) = focal_bounds(1, L0, L0, 256)
    bound2, _, _, _, t_bytes2 = focal_bounds(2, L0, L0, 256)
    results["focal_loss"] = dict(
        max_abs_err=errD[("plain", bf16)], ms=k1["ms"],
        plain_ms=p1["ms"], bound_ms=max(bound, t_bytes),
        bound_by="operations" if bound >= t_bytes else "bytes",
        library_ms=None,
        bound_unit="5 products of 2LSC (statistics and loss sim; the "
                   "backward's sim, dsim @ f1 and dsim^T @ f0) at the bf16 "
                   "tensor-core rate",
        bound_ms_two_grid_design=max(two_grid, t_bytes),
        bound_ms_all_bf16=all_bf16, bound_ms_f32_products=f32_products,
        bound_ms_forward=max(2 * bound / 5, t_bytes),
        ms_forward=k1["ms_forward"], ms_backward=k1["ms_backward"],
        device_ms=k1.get("device_ms"),
        device_ms_forward=k1.get("device_ms_forward"),
        device_ms_backward=k1.get("device_ms_backward"),
        kernels_forward_backward=k1.get("kernels_forward_backward"),
        range_device_ms_B2=k2.get("range_device_ms"),
        range_kernels_B2=k2.get("range_kernels"),
        plain_ms_forward=p1["ms_forward"],
        ms_B2=k2["ms"], ms_forward_B2=k2["ms_forward"],
        device_ms_B2=k2.get("device_ms"),
        device_ms_forward_B2=k2.get("device_ms_forward"),
        device_ms_backward_B2=k2.get("device_ms_backward"),
        plain_ms_B2=t[2]["plain"]["ms"],
        bound_ms_B2=max(bound2, t_bytes2),
        peak_mem_MiB=k1["peak_mem_MiB"], plain_peak_mem_MiB=p1["peak_mem_MiB"],
        peak_mem_MiB_B2=k2["peak_mem_MiB"],
        shape="f0=f1 [1,4800,256] bf16, forward + backward; _B2 at "
              "[2,4800,256] (checked at 11 shapes)")
    emit({"phase": 2, "kernel": "focal_loss",
          "timing": results["focal_loss"]}, log)

    # ---- hybrid fine stage: kernel C forward, recomputed plain backward --
    Cf, NB = 128, 256
    layers = [encoder_weights(init_weights(LoFTREncoderLayer(Cf, 8), s)
                              .to(dev)) for s in (2, 3)]
    w0 = rng.randn(NB, 25, Cf).astype(np.float32) * 0.5
    w1 = rng.randn(NB, 25, Cf).astype(np.float32) * 0.5
    g_out = torch.from_numpy(rng.randn(NB, 3).astype(np.float32)).to(dev)
    for dt, tol in ((f32, 2e-4), (bf16, 5e-2)):
        res = {}
        for which, fn in (("hybrid", fused_fine_stage_hybrid),
                          ("plain", KC.fine_stage_plain)):
            x0 = torch.from_numpy(w0).to(dev, dt).requires_grad_(True)
            x1 = torch.from_numpy(w1).to(dev, dt).requires_grad_(True)
            ws = [KC.EncoderWeights(*[t.detach().clone().requires_grad_(True)
                                      for t in l]) for l in layers]
            n0 = KC.fused_fine_stage.launches
            out = fn(x0, x1, ws[0], ws[1], 8)
            launched = KC.fused_fine_stage.launches - n0
            grads = torch.autograd.grad((out * g_out).sum(),
                                        [x0, x1, *ws[0], *ws[1]])
            res[which] = (out.detach(), grads, launched)
        torch.cuda.synchronize()
        (ho, hg, hl), (po, pg, _) = res["hybrid"], res["plain"]
        # the backward is autograd of the same plain function on the same
        # inputs, with the same cotangent: equal up to the order of
        # atomics in PyTorch's own backward kernels
        gerr = max(float((x.float() - y.float()).abs().max()
                         / y.float().abs().max().clamp_min(1e-30))
                   for x, y in zip(hg, pg))
        ferr = float((ho - po).abs().max())
        ok = hl == 1 and gerr <= 1e-3 and ferr <= tol * (1 + float(
            po.abs().max()))
        rec = {"phase": 2, "kernel": "fine_stage_hybrid",
               "dtype": str(dt)[6:], "forward_launches": hl,
               "forward_max_abs_err": ferr, "forward_tol": tol,
               "grad_max_rel_err": gerr, "grad_tol": 1e-3, "ok": ok}
        emit(rec, log)
        check(ok, f"hybrid fine stage disagrees: {rec}")


def reset_counts():
    from loftr_tpu_torch.ops.kernels import reset_launch_counts
    reset_launch_counts()


def read_counts():
    from loftr_tpu_torch.ops.kernels import launch_counts
    return launch_counts()


def expect_counts(counts, **want):
    """Every counter not named must read 0."""
    full = {k: want.get(k, 0) for k in counts}
    check(counts == full, f"launch counts {counts}, expected {full}")


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

def slice_fp32(dev, log, phase=3, preset="indoor_ds",
               matcher_kernel="dual_softmax"):
    import numpy as np
    import torch
    from loftr_tpu_torch.api import load_matcher, with_config
    from loftr_tpu_torch.structs import MatchInput

    model = with_config(load_matcher(preset=preset, seed=0, device=dev), {
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
    emit({"phase": phase, "preset": preset, "launches_one_forward": counts},
         log)
    expect_counts(counts, coarse_layer=12, fine_stage=1,
                  **{matcher_kernel: 1})
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
    rec = {"phase": phase, "preset": preset, "n_valid_card": int(vd.sum()),
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

def flagship_bf16(dev, log, phase=4, preset="indoor_ds",
                  matcher_kernel="dual_softmax", iters=10):
    """One preset's inference main path in bfloat16.  Returns (launch
    counts of one match_pair call, the matcher)."""
    import numpy as np
    import torch
    from loftr_tpu_torch.api import load_matcher, match_pair, with_config
    from loftr_tpu_torch.structs import MatchInput

    matcher = load_matcher(preset=preset, seed=0, device=dev)
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
    emit({"phase": phase, "main_path": f"match_pair {preset} bf16 640x480",
          "launches": main_counts, "n_matches": int(out["mconf"].shape[0])},
         log)
    expect_counts(main_counts, coarse_layer=12, fine_stage=1,
                  **{matcher_kernel: 1})

    t_mp = cuda_ms(lambda: match_pair(img0, img1, matcher), iters=iters)
    model = with_config(matcher, {"dtype": "bfloat16"})
    # the coarse stage without kernel A: the plain layer stack on cuBLAS
    plain_coarse = with_config(matcher, {"dtype": "bfloat16",
                                         "coarse": {"use_pallas": False}})
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
        ms = cuda_ms(lambda: model(inp), iters=iters)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        # per-stage split: the stages run one by one, each timed alone
        with torch.no_grad():
            f = model.extract(inp)
            fc = model.coarse(f)
            m = model.match(fc, inp)[0]
            stage = {
                "backbone_ms": cuda_ms(lambda: model.extract(inp)),
                "coarse_ms": cuda_ms(lambda: model.coarse(f)),
                "coarse_device_ms": (device_ms(lambda: model.coarse(f))
                                     or {}).get("total"),
                "coarse_plain_ms": cuda_ms(lambda: plain_coarse.coarse(f)),
                "match_ms": cuda_ms(lambda: model.match(fc, inp)),
                "fine_ms": cuda_ms(lambda: model.fine(fc, m, inp)),
            }
            # the profiler's split of the match stage: the matcher kernel's
            # bf16 path (its passes and combines, by name) against the
            # whole stage
            md = device_ms(lambda: model.match(fc, inp)) or {}
            stage["match_device_ms"] = sum(
                v for k, v in md.items() if k != "total" and (
                    f"{matcher_kernel}_bf16<" in k
                    or k in MATCH_COMBINES[matcher_kernel]))
            stage["match_device_total_ms"] = md.get("total")
            if md:
                check(any(f"{matcher_kernel}_bf16<" in k for k in md),
                      f"the match stage ran no bf16 {matcher_kernel} "
                      f"kernel: {md}")
            # the profiler's split of the fine stage: kernel C against the
            # whole stage (gather, merge and the rest)
            fd = device_ms(lambda: model.fine(fc, m, inp)) or {}
            stage["fine_device_ms"] = sum(
                v for k, v in fd.items() if k.startswith("fine_stage_bf16<"))
            stage["fine_device_total_ms"] = fd.get("total")
        rec = {"phase": phase, "preset": preset, "batch": B,
               "ms_per_batch": ms,
               "ms_per_pair": ms / B, "pairs_per_s": 1000.0 * B / ms,
               "peak_mem_MiB": peak, **stage}
        timings[f"B{B}"] = rec
        emit(rec, log)
    emit({"phase": phase, "preset": preset, "match_pair_B1_ms": t_mp}, log)
    return main_counts, matcher


# --------------------------------------------------------------------------
# phases 5 and 6: training
# --------------------------------------------------------------------------

def train_batch(seed, batch):
    """A seeded training batch: random images, depth in [1, 3], identity
    pose and a pinhole K, so the coarse ground truth is the diagonal."""
    import numpy as np
    import torch
    from loftr_tpu_torch.structs import MatchInput
    rng = np.random.RandomState(seed)
    K = np.array([[[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]]] * batch,
                 np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    t = torch.from_numpy
    return MatchInput(
        image0=t(rng.rand(batch, H, W, 1).astype(np.float32)),
        image1=t(rng.rand(batch, H, W, 1).astype(np.float32)),
        depth0=t((rng.rand(batch, H, W) * 2 + 1).astype(np.float32)),
        depth1=t((rng.rand(batch, H, W) * 2 + 1).astype(np.float32)),
        T_0to1=t(T), T_1to0=t(T.copy()), K0=t(K), K1=t(K.copy()))


def train_config(dtype, batch, preset="indoor_ds"):
    """A preset at its published widths; the schedule is cut to a constant
    1e-3 (no warm-up, no epochs) so that a few steps move the loss."""
    from loftr_tpu_torch.config import get_config
    return get_config(preset, {
        "loftr": {"dtype": dtype},
        "trainer": {"canonical_lr": 1e-3, "canonical_bs": batch,
                    "warmup_step": 0, "scheduler_interval": "step",
                    "mslr_milestones": (10 ** 9,)}})


def train_step_fp32(dev, log):
    """Phase 5: one float32 train step, card (kernels) against CPU (plain
    versions), from the same weights, batch and selection noise."""
    import torch
    from loftr_tpu_torch.ops.matching import draw_select_noise
    from loftr_tpu_torch.train.trainer import Trainer

    B = 2
    cfg = train_config("float32", B)
    batch = train_batch(5, B)
    L = (H // 8) * (W // 8)
    mc = cfg.loftr.match_coarse
    k_train = mc.train_matches or int(mc.train_coarse_percent * L)
    noise = draw_select_noise(B, L, k_train, mc.train_sampling,
                              torch.Generator().manual_seed(5), "cpu")
    out = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        trainer = Trainer(cfg, batch_size_per_device=B, device=device)
        state = trainer.init_state(seed=0)
        before = {k: v.detach().cpu().clone()
                  for k, v in state.module.state_dict().items()}
        reset_counts()
        t0 = time.perf_counter()
        state, sc = trainer.train_step(
            state, batch, {k: v.to(device) for k, v in noise.items()})
        if name == "card":
            torch.cuda.synchronize()
        out[name] = dict(
            scalars={k: float(v) for k, v in sc.items()},
            seconds=time.perf_counter() - t0, counts=read_counts(),
            before=before,
            after={k: v.detach().cpu() for k, v in
                   state.module.state_dict().items()})
        del state, trainer
    card, cpu = out["card"], out["cpu"]
    expect_counts(card["counts"], dual_softmax=1, focal_loss_forward=1,
                  focal_loss_backward=1)
    check(sum(cpu["counts"].values()) == 0, "the CPU step launched a kernel")
    lr = card["scalars"]["lr"]
    rel = {k: abs(card["scalars"][k] - cpu["scalars"][k])
           / max(abs(cpu["scalars"][k]), 1e-30)
           for k in ("loss", "loss_c", "loss_f", "grad_norm")}
    # parameters: Adam's first step moves an element by lr * sign(g), so
    # an element whose gradient is rounding noise may differ by 2 lr;
    # all others agree far below one lr.  Running statistics: float32
    # means of the same activations and of their squares.
    worst, n_far, n_all, stat_err, stat_key = 0.0, 0, 0, 0.0, None
    moved = 0.0
    for k, a in card["after"].items():
        b = cpu["after"][k]
        if k.endswith("num_batches_tracked"):
            continue
        d = (a - b).abs()
        if k.endswith(("running_mean", "running_var")):
            # this step's batch statistics, recovered from the running
            # ones.  The variance is E[x^2] - E[x]^2 in float32, so what
            # the two devices' sums carry is the second moment: errors
            # are taken against it (the mean against its square root).
            base = k.rsplit(".", 1)[0]
            mom = 0.1
            bm, bv = ((cpu["after"][base + "." + s_] - (1 - mom)
                       * cpu["before"][base + "." + s_]) / mom
                      for s_ in ("running_mean", "running_var"))
            m2 = bv + bm * bm
            scale = m2 if k.endswith("running_var") else m2.sqrt()
            e = float((d / mom / scale.clamp_min(1e-12)).max())
            if e > stat_err:
                stat_err, stat_key = e, k
            continue
        worst = max(worst, float(d.max()))
        n_far += int((d > 0.5 * lr).sum())
        n_all += d.numel()
        moved = max(moved, float((a - card["before"][k]).abs().max()))
    rec = {"phase": 5, "scalars_card": card["scalars"],
           "scalars_cpu": cpu["scalars"], "rel_err": rel,
           "param_max_abs_diff": worst, "lr": lr,
           "param_frac_beyond_half_lr": n_far / n_all,
           "param_max_update": moved, "running_stat_max_rel_err": stat_err,
           "running_stat_worst": stat_key,
           "card_step_s": card["seconds"], "cpu_step_s": cpu["seconds"],
           "launches": card["counts"]}
    # tolerances: the losses are means over millions of float terms in
    # another order (1e-3); the gradient norm also carries ReLU-mask flips
    # between two float32 convolution libraries (2e-2)
    rec["ok"] = (rel["loss"] <= 1e-3 and rel["loss_c"] <= 1e-3
                 and rel["loss_f"] <= 1e-3 and rel["grad_norm"] <= 2e-2
                 and worst <= 2.2 * lr and n_far / n_all <= 0.05
                 and moved >= 0.5 * lr and stat_err <= 1e-3)
    emit(rec, log)
    check(rec["ok"], f"fp32 train step: card and CPU disagree: {rec}")


def train_bf16(dev, log, steps=8):
    """Phase 6: the training main path, ``Trainer.train_step`` in
    bfloat16.  Returns the launch counts of the B=2 run."""
    import math
    import torch
    from loftr_tpu_torch.losses import loftr_loss
    from loftr_tpu_torch.supervision import (coarse_supervision,
                                             fine_supervision)
    from loftr_tpu_torch.train.trainer import Trainer

    main_counts = None
    for B in (2, 4):
        cfg = train_config("bfloat16", B)
        trainer = Trainer(cfg, batch_size_per_device=B, device=dev)
        state = trainer.init_state(seed=0)
        batch = train_batch(6, B).to(dev)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_counts()
        losses = []
        t0 = time.perf_counter()
        for _ in range(steps):
            state, sc = trainer.train_step(state, batch)
            losses.append(sc)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        scal = [{k: float(v) for k, v in s.items()} for s in losses]
        expect_counts(counts, dual_softmax=steps, focal_loss_forward=steps,
                      focal_loss_backward=steps)
        check(all(math.isfinite(v) for s in scal for v in s.values()),
              f"non-finite training scalars: {scal}")
        check(scal[-1]["loss"] < scal[0]["loss"],
              f"the loss did not fall: {[s['loss'] for s in scal]}")
        check(all(p.dtype == torch.float32
                  for p in state.module.parameters()),
              "parameters must stay float32")
        if B == 2:
            main_counts = counts

        # steady-state time of the entry point itself, by CUDA events
        # around each of 5 further Trainer.train_step calls (the 8 steps
        # above have warmed the allocator and the convolution algorithms)
        timed = 5
        tev = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
        state, _ = trainer.train_step(state, batch)
        tev[0].record()
        for i in range(timed):
            state, _ = trainer.train_step(state, batch)
            tev[i + 1].record()
        torch.cuda.synchronize()
        per_step = [tev[i].elapsed_time(tev[i + 1]) for i in range(timed)]
        step_ms = sum(per_step) / timed

        # the step's device time, and kernel D's: the kernels the profiler
        # links to its forward and backward ops (kernel B's matcher runs
        # the same statistics kernels in the step)
        holder = [state]

        def one_step():
            holder[0], _ = trainer.train_step(holder[0], batch)
        dms = device_ms(one_step, iters=3)
        focal = range_device_ms(one_step, FOCAL_OPS)
        state = holder[0]

        # the per-stage breakdown: the step's stages written out one by
        # one with an event between them.  It is not the entry point: it
        # leaves out train_step's batch.to, the zero fill of unused
        # gradients and the grad_norm scalar, so its sum is reported beside
        # ms_per_step, not in its place.
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(6)]
              for _ in range(4)]
        res_c, res_f = cfg.loftr.backbone.resolution
        for e in ev:
            e[0].record()
            model = state.module.train()
            spv = coarse_supervision(batch, res_c)
            e[1].record()
            out = model(batch, train=True, generator=state.generator,
                        gt_j=spv.gt_j, gt_valid=spv.gt_valid)
            e[2].record()
            gt = fine_supervision(spv, out.coarse, batch, res_f,
                                  cfg.loftr.fine.window_size)
            loss, _ = loftr_loss(out, spv, gt, batch, cfg.loftr.loss,
                                 cfg.loftr.match_coarse)
            e[3].record()
            grads = list(torch.autograd.grad(
                loss, list(model.parameters())))
            e[4].record()
            trainer.apply_gradients(state, grads)
            e[5].record()
        torch.cuda.synchronize()
        split = [sum(e[i].elapsed_time(e[i + 1]) for e in ev[1:]) / 3
                 for i in range(5)]
        rec = {"phase": 6, "main_path": "Trainer.train_step indoor_ds bf16 "
               "640x480", "batch": B, "steps": steps,
               "loss": [s["loss"] for s in scal],
               "loss_c": [scal[0]["loss_c"], scal[-1]["loss_c"]],
               "loss_f": [scal[0]["loss_f"], scal[-1]["loss_f"]],
               "grad_norm": [scal[0]["grad_norm"], scal[-1]["grad_norm"]],
               "lr": scal[-1]["lr"], "launches": counts,
               "ms_per_step_first_steps_wall": wall,
               "ms_per_step": step_ms, "ms_each_timed_step": per_step,
               "pairs_per_s": 1000.0 * B / step_ms,
               "stages_sum_ms": sum(split),
               "step_minus_stages_ms": step_ms - sum(split),
               "supervision_ms": split[0], "forward_ms": split[1],
               "loss_ms": split[2], "backward_ms": split[3],
               "optimizer_ms": split[4], "peak_mem_MiB": peak,
               "device_ms_per_step": dms and dms["total"],
               "focal_device_ms": focal and focal["total"],
               "focal_kernels": focal}
        emit(rec, log)
        del state, trainer, batch, out, loss, grads
        torch.cuda.empty_cache()
    return main_counts


# --------------------------------------------------------------------------
# phase 8 (second half): the two module switches; phase 9: OT training
# --------------------------------------------------------------------------

def ot_switches(dev, log, matcher):
    """The backbone with the upsample switch on, and the fine layer stack
    with ``fused_window_attn`` on followed by ``fine_match``, each once at
    B=1 with the launch counters reset just before, and each compared with
    the switch off.  Returns the launch counts of the two runs."""
    import torch
    import loftr_tpu_torch.models.backbone as BB
    from loftr_tpu_torch.api import with_config
    from loftr_tpu_torch.models.transformer import LocalFeatureTransformer
    from loftr_tpu_torch.ops.fine_match import fine_match
    from loftr_tpu_torch.structs import MatchInput

    model = with_config(matcher, {"dtype": "bfloat16"})
    a, b = images(4, 1)
    inp = MatchInput(image0=torch.from_numpy(a[..., None]).to(dev),
                     image1=torch.from_numpy(b[..., None]).to(dev))
    off = model.extract(inp)
    t_off = cuda_ms(lambda: model.extract(inp))
    BB._USE_PALLAS_UPSAMPLE = True
    try:
        model.extract(inp)                                   # warm-up
        torch.cuda.synchronize()
        reset_counts()
        on = model.extract(inp)
        torch.cuda.synchronize()
        up_counts = read_counts()
        t_on = cuda_ms(lambda: model.extract(inp))
    finally:
        BB._USE_PALLAS_UPSAMPLE = False
    expect_counts(up_counts, upsample=2)
    rec = {"phase": 8, "switch": "backbone _USE_PALLAS_UPSAMPLE",
           "launches": up_counts, "backbone_ms_off": t_off,
           "backbone_ms_on": t_on}
    # tolerance: the kernel's maps equal the matmul form's to one bf16 ulp
    # on a few entries; two 3x3 convolutions carry that on, so the feature
    # maps agree to a few ulps of their largest entry
    ok = True
    for name in ("feat_c0", "feat_c1", "feat_f0", "feat_f1"):
        x, y = getattr(on, name).float(), getattr(off, name).float()
        d = (x - y).abs()
        rec[name + "_max_abs_diff"] = float(d.max())
        rec[name + "_max_abs"] = float(y.abs().max())
        ok = ok and bool(torch.isfinite(x).all()) \
            and float(d.max()) <= 2 ** -5 * float(y.abs().max()) \
            and float(d.mean()) <= 1e-3 * float(y.abs().max())
    rec["ok"] = ok
    emit(rec, log)
    check(ok, f"backbone with the upsample kernel disagrees: {rec}")

    # the 1024 windows of this call, through the fine layer stack
    fc = model.coarse(off)
    m = model.match(fc, inp)[0]
    win0, win1 = model.fine_windows(fc, m, inp)
    Bk, K, ww, d_f = win0.shape
    w0 = win0.reshape(Bk * K, ww, d_f).contiguous()
    w1 = win1.reshape(Bk * K, ww, d_f).contiguous()
    fcfg = model.config.fine
    stack = LocalFeatureTransformer(fcfg.d_model, fcfg.nhead,
                                    fcfg.layer_names,
                                    fused_window_attn=True).to(dev).eval()
    stack.load_state_dict(model.loftr_fine.state_dict())

    def run(tr):
        f0, f1 = tr(w0, w1)
        return fine_match(f0.reshape(Bk, K, ww, d_f),
                          f1.reshape(Bk, K, ww, d_f))
    want = run(model.loftr_fine)
    run(stack)                                               # warm-up
    torch.cuda.synchronize()
    reset_counts()
    got = run(stack)
    torch.cuda.synchronize()
    wa_counts = read_counts()
    expect_counts(wa_counts, window_attention=3)
    d = (got - want).abs()
    # tolerance: window coordinates in [-1, 1] from bf16 features that
    # differ by rounding (kernel C's bar against its plain version, 5e-2)
    ok = bool(torch.isfinite(got).all()) and float(d.max()) <= 5e-2
    rec = {"phase": 8, "switch": "fine stack fused_window_attn",
           "windows": Bk * K, "launches": wa_counts,
           "expec_f_max_abs_diff": float(d.max()),
           "expec_f_mean_abs_diff": float(d.mean()), "tol": 5e-2,
           "fine_stack_ms_off": cuda_ms(lambda: run(model.loftr_fine)),
           "fine_stack_ms_on": cuda_ms(lambda: run(stack)), "ok": ok}
    emit(rec, log)
    check(ok, f"fine stack with fused_window_attn disagrees: {rec}")
    return up_counts, wa_counts


def train_ot(dev, log, steps=4):
    """Phase 9: ``Trainer.train_step`` with ``indoor_ot`` in bfloat16 at
    B=2 (the plain Sinkhorn path: OT training runs no kernel of its own)."""
    import math
    import torch
    from loftr_tpu_torch.train.trainer import Trainer

    B = 2
    cfg = train_config("bfloat16", B, "indoor_ot")
    trainer = Trainer(cfg, batch_size_per_device=B, device=dev)
    state = trainer.init_state(seed=0)
    batch = train_batch(8, B).to(dev)
    bin_score = state.module.coarse_matching.bin_score
    loss, _, out = trainer.forward_loss(state, batch)
    check(out.conf_matrix is not None and out.feat_c0 is None,
          "OT training must take the plain confidence matrix")
    g_bin = float(torch.autograd.grad(loss, bin_score)[0])
    del loss, out
    check(math.isfinite(g_bin) and g_bin != 0.0,
          f"bin_score gradient {g_bin}")
    start = float(bin_score.detach())
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    scal = []
    for _ in range(steps):
        state, sc = trainer.train_step(state, batch)
        scal.append({k: float(v) for k, v in sc.items()})
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    expect_counts(counts)
    check(all(math.isfinite(v) for s_ in scal for v in s_.values()),
          f"non-finite OT training scalars: {scal}")
    check(float(bin_score.detach()) != start, "bin_score did not move")
    timed = 3
    tev = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    tev[0].record()
    for i in range(timed):
        state, _ = trainer.train_step(state, batch)
        tev[i + 1].record()
    torch.cuda.synchronize()
    per_step = [tev[i].elapsed_time(tev[i + 1]) for i in range(timed)]
    step_ms = sum(per_step) / timed
    emit({"phase": 9, "main_path": "Trainer.train_step indoor_ot bf16 "
          "640x480", "batch": B, "steps": steps,
          "loss": [s_["loss"] for s_ in scal],
          "loss_c": [scal[0]["loss_c"], scal[-1]["loss_c"]],
          "grad_norm": [scal[0]["grad_norm"], scal[-1]["grad_norm"]],
          "bin_score_grad_first_step": g_bin,
          "bin_score": [start, float(bin_score.detach())],
          "launches": counts, "ms_per_step": step_ms,
          "ms_each_timed_step": per_step,
          "pairs_per_s": 1000.0 * B / step_ms, "peak_mem_MiB": peak}, log)


# --------------------------------------------------------------------------
# phase 10: the evaluation path
# --------------------------------------------------------------------------

EVAL_SOLVERS = ("batched", "opencv", "native", "5pt", "batched5pt")
EVAL_KEYS = {"auc@5", "auc@10", "auc@20", "prec@1e-04"}


def exact_matches(item, n, outlier_frac, rng):
    """``n`` exact correspondences of a pair: depth-valid pixels of view 0
    projected into view 1 with the ground-truth pose (float64, then
    float32), a share ``outlier_frac`` of them replaced by random points."""
    import numpy as np
    d0 = item["depth0"]
    K0, K1 = item["K0"].astype(np.float64), item["K1"].astype(np.float64)
    T = item["T_0to1"].astype(np.float64)
    ys, xs = np.nonzero(d0 > 0)
    sel = rng.choice(len(xs), 4 * n, replace=False)
    u = np.stack([xs[sel], ys[sel]], -1).astype(np.float64)
    X0 = d0[ys[sel], xs[sel]][:, None] * (
        np.c_[u, np.ones(len(u))] @ np.linalg.inv(K0).T)
    X1 = X0 @ T[:3, :3].T + T[:3, 3]
    keep = np.nonzero(X1[:, 2] > 0)[0][:n]
    check(len(keep) == n, f"only {len(keep)} points in front of view 1")
    p1 = X1[keep] @ K1.T
    k1 = p1[:, :2] / p1[:, 2:]
    out = rng.rand(n) < outlier_frac
    k1[out] = rng.rand(int(out.sum()), 2) * np.array(d0.shape[::-1])
    return u[keep].astype(np.float32), k1.astype(np.float32)


def pose_angles(T, R, t):
    """(R error, t error) in degrees from the chord lengths, 2 asin(|R -
    R_gt|_F / sqrt 8) and 2 asin(|t^ -+ t^_gt| / 2): the same angles as
    ``relative_pose_error``'s arccos of a trace and a dot product, without
    its loss near 0 (arccos(1 - d) of a float32 rotation reads ~0.03 deg
    for an exact one)."""
    import numpy as np
    R_gt, t_gt = T[:3, :3], T[:3, 3] / np.linalg.norm(T[:3, 3])
    tn = t / np.linalg.norm(t)
    chord_t = min(np.linalg.norm(tn - t_gt), np.linalg.norm(tn + t_gt))
    chord_R = np.linalg.norm(R - R_gt) / np.sqrt(8.0)
    return (float(np.rad2deg(2 * np.arcsin(min(chord_R, 1.0)))),
            float(np.rad2deg(2 * np.arcsin(min(chord_t / 2, 1.0)))))


def crop_views(root, npzs, size):
    """Crop views of a synthetic set to MegaDepth's aspects in place, image
    and depth alike: view 1 of every scene to 3:2 landscape (the bottom
    rows cut) and view 2 of the second scene to 2:3 portrait (the right
    columns cut).  A bottom or right crop keeps K and the pose.  Padded
    back to ``size``^2, each such view leaves a third of its coarse cells
    invalid."""
    import cv2
    import numpy as np
    keep = size * 2 // 3
    for i, npz in enumerate(npzs):
        info = np.load(npz, allow_pickle=True)
        views = [(1, np.s_[:keep, :])]
        if i == 1:
            views.append((2, np.s_[:, :keep]))
        for v, sl in views:
            ip = os.path.join(root, info["image_paths"][v])
            cv2.imwrite(ip, cv2.imread(ip, cv2.IMREAD_UNCHANGED)[sl])
            dp = os.path.join(root, info["depth_paths"][v])
            np.save(dp, np.load(dp)[sl])


def eval_kernel_checks(dev, log, mask0, mask1, n_windows):
    """Phase 10's kernels against their plain versions at the shapes the
    evaluation path gives them: kernel A's packed self layer [2, L, 256]
    and a cross layer [1, L, 256], and kernel B at L = S, each with the
    padding masks of one evaluated pair (``mask0``, ``mask1``: flattened
    coarse masks, numpy bool [L]); kernel C at ``n_windows`` window pairs
    (max_matches).  Phase 2's inputs, weights and tolerances."""
    import numpy as np
    from loftr_tpu_torch.models.fused_fine import encoder_weights
    from loftr_tpu_torch.models.transformer import LoFTREncoderLayer
    from loftr_tpu_torch.utils.weights import init_weights

    def enc(c, seed):
        layer = init_weights(LoFTREncoderLayer(c, 8), seed).to(dev)
        return encoder_weights(layer)

    rng = np.random.RandomState(10)
    L, C, Cf = mask0.size, 256, 128
    m0, m1 = mask0[None], mask1[None]
    m01 = np.concatenate([m0, m1])
    wA = enc(C, 1)
    check_coarse(dev, log, wA, f"self_B2_L{L}_padded",
                 rng.randn(2, L, C) * 0.5, None, m01, m01, phase=10)
    check_coarse(dev, log, wA, f"cross_B1_L{L}_padded",
                 rng.randn(1, L, C) * 0.5, rng.randn(1, L, C) * 0.5, m0, m1,
                 phase=10)
    # correspondences planted between valid cells, as phase 2 plants them
    f0 = rng.randn(1, L, C).astype(np.float32)
    f1 = rng.randn(1, L, C).astype(np.float32)
    v0, v1 = np.nonzero(mask0)[0], np.nonzero(mask1)[0]
    n = min(len(v0), len(v1)) // 12
    f1[0, rng.permutation(v1)[:n]] = (f0[0, rng.permutation(v0)[:n]]
                                      + 0.1 * rng.randn(n, C))
    check_dual(dev, log, f"B1_L{L}_S{L}_padded", f0, f1, m0, m1, phase=10)
    check_fine(dev, log, enc(Cf, 2), enc(Cf, 3),
               rng.randn(n_windows, 25, Cf) * 0.5,
               rng.randn(n_windows, 25, Cf) * 0.5, phase=10)


def eval_path(dev, log, smi, n_scenes=2, n_views=3, size=840):
    """Phase 10: the evaluation path on synthetic MegaDepth scenes at
    ``size`` px with full-width ``outdoor_ds`` in bf16 and random weights
    (thr 0 so that matches exist), some views cropped to MegaDepth's
    aspects so that the padding masks are partial:
    ``loftr_tpu_torch.test.main`` with every pose solver, the launch counts
    of its ``batched`` run, kernels A, B and C against their plain versions
    at that run's shapes and masks, the device
    solvers on exact correspondences (with and without 30% outliers)
    against the ground-truth pose, the card's epipolar errors against the
    CPU's, and timings.  Returns the launch counts of the main path."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from loftr_tpu_torch import test as cli
    from loftr_tpu_torch.config import get_config
    from loftr_tpu_torch.data import DataLoader, MegaDepthDataset
    from loftr_tpu_torch.data.sampler import ConcatDataset
    from loftr_tpu_torch.data.synthetic import make_synthetic_megadepth
    from loftr_tpu_torch.eval import ransac
    from loftr_tpu_torch.eval.evaluator import Evaluator
    from loftr_tpu_torch.eval.five_point import estimate_pose_5pt
    from loftr_tpu_torch.eval.metrics import (essential_from_pose,
                                              relative_pose_error,
                                              symmetric_epipolar_distance)
    from loftr_tpu_torch.eval.pose import estimate_pose_opencv
    from loftr_tpu_torch.models.matcher import LoFTR
    from loftr_tpu_torch.native import estimate_pose_native
    from loftr_tpu_torch.utils.weights import init_weights

    root = tempfile.mkdtemp(prefix="loftr_eval_")
    try:
        t0 = time.perf_counter()
        # .npy depth: the card's machine has no h5py, so its .h5 read is
        # not covered here
        npzs = make_synthetic_megadepth(root, n_scenes=n_scenes,
                                        n_views=n_views, img_size=size,
                                        seed=0, depth_format="npy")
        crop_views(root, npzs, size)
        write_s = time.perf_counter() - t0
        n_pairs = sum(len(np.load(p, allow_pickle=True)["pair_infos"])
                      for p in npzs)
        args = ["--preset", "outdoor_ds", "--dataset", "megadepth",
                "--data-root", root, "--npz-root",
                os.path.join(root, "index"), "--img-resize", str(size),
                "--dtype", "bfloat16", "--thr", "0", "--num-workers", "4"]

        # the CLI, once with each solver; the batched run is the main path
        main_counts, cli_runs = None, {}
        for solver in EVAL_SOLVERS:
            torch.cuda.synchronize()
            if solver == "batched":
                reset_counts()
            t = time.perf_counter()
            agg = cli.main(args + ["--pose-solver", solver])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if solver == "batched":
                main_counts = read_counts()
            check(set(agg) == EVAL_KEYS and all(
                np.isfinite(v) for v in agg.values()),
                f"test.main with {solver}: {agg}")
            cli_runs[solver] = {"metrics": agg, "wall_s": wall}
        emit({"phase": 10, "main_path": "python -m loftr_tpu_torch.test "
              f"outdoor_ds bf16 megadepth {size}px --pose-solver batched",
              "pairs": n_pairs, "launches": main_counts,
              "write_data_s": write_s, "cli": cli_runs}, log)
        expect_counts(main_counts, coarse_layer=12 * n_pairs,
                      dual_softmax=n_pairs, fine_stage=n_pairs)

        # timings on batches in memory: model + epipolar errors + solver
        cfg = get_config("outdoor_ds", {
            "loftr": {"dtype": "bfloat16",
                      "match_coarse": {"thr": 0.0, "max_matches": 2048}},
            "trainer": {"epi_err_thr": 1e-4}})
        model = init_weights(LoFTR(cfg.loftr), 0)
        dss = [MegaDepthDataset(root, p, mode="test", img_resize=size, df=8,
                                img_padding=True) for p in npzs]
        batches = list(DataLoader(ConcatDataset(dss), 1, num_workers=4,
                                  drop_last=False))
        # the padding masks the CLI's runs gave kernels A and B (the same
        # dataset); the pair with the fewest valid cells is checked below
        masks = [(b[0].mask0.reshape(-1).numpy(),
                  b[0].mask1.reshape(-1).numpy()) for b in batches]
        valid_share = [[float(m.mean()) for m in pair] for pair in masks]
        emit({"phase": 10, "coarse_mask_valid_share": valid_share}, log)
        check(any(min(v) < 1.0 for v in valid_share),
              f"every coarse mask of the eval set is all valid: "
              f"{valid_share}")
        with torch.no_grad():
            eval_kernel_checks(dev, log, *min(masks, key=lambda m: sum(
                x.sum() for x in m)), cfg.loftr.match_coarse.max_matches)
        timing = {}
        for solver in EVAL_SOLVERS:
            ev = Evaluator(cfg, model, pose_solver=solver, device=dev)
            ev.evaluate_batches(batches[:1])                   # warm-up
            t = time.perf_counter()
            ev.evaluate_batches(batches)
            wall = time.perf_counter() - t
            n = ev.timing["pairs"]
            timing[solver] = {
                "pairs_per_s": n / wall,
                "model_and_epipolar_ms_per_pair":
                    1e3 * ev.timing["model_s"] / n,
                "solver_ms_per_pair": 1e3 * ev.timing["pose_s"] / n}
        inp = batches[0][0].to(dev)
        with torch.inference_mode():
            res = model.eval().to(dev)(inp)
            model_ms = cuda_ms(lambda: model(inp), iters=5)
            n_valid = int(res.valid.sum())
            # the card's epipolar errors against the CPU's, same inputs
            args_e = [res.mkpts0_f.float(), res.mkpts1_f.float(),
                      essential_from_pose(inp.T_0to1), inp.K0, inp.K1]
            epi_d = symmetric_epipolar_distance(*args_e).cpu().numpy()
            epi_c = symmetric_epipolar_distance(
                *[a.cpu() for a in args_e]).numpy()
        v = res.valid.cpu().numpy()
        rel = np.abs(epi_d - epi_c) / np.maximum(np.abs(epi_c), 1e-30)
        epi_ok = bool(np.allclose(epi_d, epi_c, rtol=1e-5, atol=1e-12))
        emit({"phase": 10, "nvidia_smi": smi, "model_ms_B1": model_ms,
              "n_valid": n_valid, "eval": timing,
              "epipolar_card_vs_cpu": {
                  "max_rel": float(rel.max()),
                  "max_rel_valid": float(rel[v].max()) if v.any() else 0.0,
                  "equal_share": float((epi_d == epi_c).mean()),
                  "rtol": 1e-5, "ok": epi_ok}}, log)
        check(epi_ok, "card and CPU epipolar errors differ beyond rtol 1e-5")
        check(n_valid > 0, "the eval forward found no matches")

        # exact correspondences: device solvers within 0.1 deg of the
        # ground truth, the host solvers as a cross-check
        item = MegaDepthDataset(root, npzs[0], mode="val")[0]
        T = item["T_0to1"].astype(np.float64)
        K0, K1 = item["K0"], item["K1"]
        rng = np.random.RandomState(0)
        exact = {}
        for frac in (0.0, 0.3):
            k0, k1 = exact_matches(item, 500, frac, rng)
            row = {}
            for solver, H in (("8pt", 1024), ("5pt", 128)):
                name = "batched" if solver == "8pt" else "batched5pt"
                tk = [torch.from_numpy(a)[None].to(dev)
                      for a in (k0, k1, K0, K1)]
                valid = torch.ones(1, len(k0), dtype=torch.bool,
                                   device=dev)

                def run():
                    return ransac.estimate_pose_ransac(
                        *tk, valid, pixel_thr=0.5, num_hypotheses=H,
                        solver=solver,
                        generator=torch.Generator(device=dev).manual_seed(0))
                with torch.inference_mode():
                    est = run()
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    for _ in range(3):
                        run()
                    torch.cuda.synchronize()
                    ms = 1e3 * (time.perf_counter() - t) / 3
                    dms = (device_ms(run, iters=3) or {}).get("total")
                R, tv = (est.R[0].double().cpu().numpy(),
                         est.t[0].double().cpu().numpy())
                row[name] = dict(zip(("R_err_deg", "t_err_deg"),
                                     pose_angles(T, R, tv)))
                row[name].update(
                    dict(zip(("t_err_metric_deg", "R_err_metric_deg"),
                             relative_pose_error(T, R, tv))),
                    inliers=int(est.num_inliers[0]), ms=ms, device_ms=dms)
            host = {
                "opencv": lambda: estimate_pose_opencv(
                    k0.astype(np.float64), k1.astype(np.float64),
                    K0.astype(np.float64), K1.astype(np.float64), 0.5),
                "native": lambda: estimate_pose_native(k0, k1, K0, K1, 0.5),
                "5pt": lambda: estimate_pose_5pt(k0, k1, K0, K1, 0.5)}
            for name, fn in host.items():
                t = time.perf_counter()
                ret = fn()
                ms = 1e3 * (time.perf_counter() - t)
                check(ret is not None, f"{name} found no pose")
                row[name] = dict(zip(("R_err_deg", "t_err_deg"),
                                     pose_angles(T, ret[0], ret[1])))
                row[name].update(
                    dict(zip(("t_err_metric_deg", "R_err_metric_deg"),
                             relative_pose_error(T, ret[0], ret[1]))),
                    inliers=int(ret[2].sum()), ms=ms)
            exact[f"outliers_{frac}"] = row
        emit({"phase": 10, "exact_correspondences": 500, "pose": exact},
             log)
        for frac, row in exact.items():
            for name, r in row.items():
                bar = 0.1 if name.startswith("batched") else 2.0
                check(r["R_err_deg"] < bar and r["t_err_deg"] < bar,
                      f"{name} with {frac}: {r} (bar {bar} deg)")
        return main_counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 11: the training CLI and the short accuracy smoke
# --------------------------------------------------------------------------

def focal_cli_check(dev, log, size, n_gt):
    """Kernel D against its plain version at the train CLI's shape,
    [1, L, 256] with L = S = (``size`` / 8)^2, ``n_gt`` planted
    ground-truth cells and the coarse padding masks of a 3:2 landscape
    view against a 2:3 portrait one (as ``crop_views`` writes them, padded
    back to ``size``^2): float32 and bf16, forward and backward, at phase
    2's tolerances."""
    import numpy as np
    side = size // 8
    keep = side * 2 // 3
    m0 = np.zeros((side, side), bool)
    m1 = np.zeros((side, side), bool)
    m0[:keep] = True
    m1[:, :keep] = True
    m0, m1 = m0.reshape(1, -1), m1.reshape(1, -1)
    cells = (np.nonzero(m0[0])[0], np.nonzero(m1[0])[0])
    f0, f1, gt_j, gt_valid = focal_case(
        np.random.RandomState(11), 1, side * side, 256, n_gt,
        n_alike=min(len(cells[0]), len(cells[1])) // 2, cells=cells)
    check(int(gt_valid.sum()) == n_gt, f"planted {gt_valid.sum()} of {n_gt}")
    check_focal(dev, log, f"train_cli_L{side * side}_padded", f0, f1, gt_j,
                gt_valid, m0, m1, phase=11)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f]


def train_cli_path(dev, log, smi, size=840, steps_per_epoch=4):
    """Phase 11: ``loftr_tpu_torch.train.cli.main`` in-process with
    full-width ``outdoor_ds`` in bf16 at ``size`` px (L = S = 11025, B=1)
    on synthetic MegaDepth scenes (2 x 4 views to train, 1 x 3 to validate,
    ``.npy`` depth, some views cropped to MegaDepth's aspects so that the
    padding masks are partial): 2 epochs of ``steps_per_epoch`` steps,
    validation every epoch with the batched solver and one figure (skipped
    where ``matplotlib`` is missing), checkpoints in a temporary directory;
    then ``--resume`` for one more epoch, which must load the saved tensors
    bit for bit and log the saved step + 1 first.  Kernel D against its
    plain version at the CLI's training shape with MegaDepth's padding
    masks (``focal_cli_check``).  Timings: ms/step from the logger's times
    and from CUDA events around ``Trainer.train_step`` alone, val pairs/s,
    checkpoint size and save time, peak memory.  Then the short accuracy
    smoke:
    ``synthetic_benchmark.main`` with the small model at 256 px (2 train
    scenes and 1 held-out scene of 8 views, 300 steps, the untrained
    control), whose loss must fall below a quarter and whose trained
    auc@20 must exceed the untrained.  Returns the launch counts of the
    first ``main`` (the main path)."""
    import contextlib
    import shutil
    import tempfile
    import numpy as np
    import torch
    from loftr_tpu_torch.config import get_config
    from loftr_tpu_torch.data import DataLoader, MegaDepthDataset
    from loftr_tpu_torch.data.synthetic import make_synthetic_megadepth
    from loftr_tpu_torch.eval.evaluator import Evaluator
    from loftr_tpu_torch.tools import synthetic_benchmark as bench
    from loftr_tpu_torch.train import cli
    from loftr_tpu_torch.train.checkpoint import CheckpointManager
    from loftr_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="loftr_train_")
    saves, vals, restored, step_masks = [], [], {}, []
    orig = (CheckpointManager.save, CheckpointManager.restore,
            Evaluator.evaluate_dataset, Trainer.train_step)

    def timed_save(self, step, state, metrics=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        orig[0](self, step, state, metrics)
        saves.append({"step": step, "s": time.perf_counter() - t,
                      "MiB": os.path.getsize(self.path(step)) / 2**20})

    def recording_restore(self, state, step=None):
        state = orig[1](self, state, step)
        restored["step"] = state.step
        restored["module"] = {k: v.detach().clone() for k, v in
                              state.module.state_dict().items()}
        restored["optimizer"] = copy.deepcopy(state.optimizer.state_dict())
        return state

    def timed_val(self, dataset, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig[2](self, dataset, **kw)
        torch.cuda.synchronize()
        vals.append({"pairs": self.timing["pairs"],
                     "s": time.perf_counter() - t})
        return out

    def mask_recording_step(self, state, batch, noise=None):
        # the share of valid coarse cells of each image of the step's pair
        step_masks.append([float(m.float().mean())
                           for m in (batch.mask0, batch.mask1)])
        return orig[3](self, state, batch, noise)

    CheckpointManager.save = timed_save
    CheckpointManager.restore = recording_restore
    Evaluator.evaluate_dataset = timed_val
    Trainer.train_step = mask_recording_step
    try:
        t0 = time.perf_counter()
        npzs = make_synthetic_megadepth(root, n_scenes=2, n_views=4,
                                        img_size=size, seed=0,
                                        depth_format="npy")
        crop_views(root, npzs, size)
        val = os.path.join(root, "val")
        val_npz, = make_synthetic_megadepth(
            val, n_scenes=1, n_views=3, img_size=size, seed=11,
            scene_prefix="val", depth_format="npy")
        crop_views(val, [val_npz], size)
        write_s = time.perf_counter() - t0
        n_val = len(np.load(val_npz, allow_pickle=True)["pair_infos"])
        ck = os.path.join(root, "ckpt")
        overrides = {"loftr": {"dtype": "bfloat16"},
                     "trainer": {"epi_err_thr": 1e-4}}
        args = ["--preset", "outdoor_ds", "--dataset", "megadepth",
                "--data-root", root, "--npz-root",
                os.path.join(root, "index"), "--list-path",
                os.path.join(root, "index", "scene_list.txt"),
                "--img-resize", str(size), "--batch-size", "1",
                "--n-samples-per-subset", str(steps_per_epoch // 2),
                "--log-every", "1", "--num-workers", "4",
                "--val-npz-path", val_npz, "--val-data-root", val,
                "--val-pose-solver", "batched", "--val-figures", "1",
                "--ckpt-dir", ck, "--config-json", json.dumps(overrides)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            state = cli.main(args + ["--max-epochs", "2"])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t
        counts = read_counts()
        Trainer.train_step = orig[3]
        cli_masks = step_masks[:]
        peak = torch.cuda.max_memory_allocated() / 2**20
        n_steps = 2 * steps_per_epoch
        recs = _jsonl(os.path.join(ck, "logs", "metrics.jsonl"))
        train_recs = [r for r in recs if "phase" not in r]
        val_recs = [r for r in recs if r.get("phase") == "val"]
        index = json.load(open(os.path.join(ck, "checkpoints.json")))
        fig_dir = os.path.join(ck, "logs", "figures")
        figures = sorted(os.listdir(fig_dir)) if os.path.isdir(fig_dir) \
            else []
        # ms/step from the logger's times (10 ms resolution): each epoch's
        # first step excluded (it waits for the loader)
        by_epoch = [[r["time"] for r in train_recs if r["epoch"] == e]
                    for e in range(2)]
        logger_ms = [1e3 * (ts[-1] - ts[0]) / (len(ts) - 1)
                     for ts in by_epoch]
        emit({"phase": 11, "main_path": "python -m loftr_tpu_torch.train "
              f"outdoor_ds bf16 megadepth {size}px B=1, "
              f"{n_steps} steps, val --pose-solver batched",
              "nvidia_smi": smi, "launches": counts, "steps": state.step,
              "losses": [r["loss"] for r in train_recs],
              "val": val_recs, "checkpoint_index": index,
              "figures": figures,
              # no matplotlib on the card's machine: the CLI then skips
              # --val-figures with a warning (the CPU tests cover figures)
              "figures_available": bench.figures_available(),
              "write_data_s": write_s, "main_s": main_s,
              "logger_ms_per_step": logger_ms, "val_timing": vals,
              "checkpoint_saves": saves, "peak_mem_MiB": peak,
              "train_coarse_mask_valid_share": cli_masks,
              "tf32": [torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32]}, log)
        check(len(cli_masks) == n_steps
              and any(min(v) < 1.0 for v in cli_masks),
              f"every coarse mask of the CLI's training steps is all valid: "
              f"{cli_masks}")
        check(state.step == n_steps and [r["step"] for r in train_recs]
              == list(range(1, n_steps + 1)),
              f"train CLI steps: {[r['step'] for r in train_recs]}")
        check(all(np.isfinite(r["loss"]) for r in train_recs),
              f"train CLI losses: {[r['loss'] for r in train_recs]}")
        check(len(val_recs) == 2 and all(
            set(r) == EVAL_KEYS | {"step", "time", "epoch", "phase"}
            and all(np.isfinite(r[k]) for k in EVAL_KEYS)
            for r in val_recs), f"train CLI val records: {val_recs}")
        check(sorted(index) == [str(steps_per_epoch), str(n_steps)] and all(
            v is not None for v in index.values()),
              f"checkpoint index without auc@10: {index}")
        check(len(figures) == 2 or not bench.figures_available(),
              f"val figures: {figures}")
        expect_counts(counts, coarse_layer=12 * 2 * n_val,
                      dual_softmax=n_steps + 2 * n_val,
                      fine_stage=2 * n_val, focal_loss_forward=n_steps,
                      focal_loss_backward=n_steps)
        mc = get_config("outdoor_ds", overrides).loftr.match_coarse
        focal_cli_check(dev, log, size, mc.train_matches or int(
            mc.train_coarse_percent * (size // 8) ** 2))

        # --resume: the saved tensors load bit for bit, the step carries on
        saved = torch.load(os.path.join(ck, f"step_{n_steps:08d}.pt"),
                           map_location="cpu", weights_only=False)
        n_before = len(recs)
        with contextlib.redirect_stdout(sys.stderr):
            resumed = cli.main(args + ["--resume", "--max-epochs", "1"])
        torch.cuda.synchronize()
        new = [r for r in _jsonl(os.path.join(ck, "logs", "metrics.jsonl"))
               [n_before:] if "phase" not in r]
        same_module = all(torch.equal(v.cpu(), saved["module"][k])
                          for k, v in restored["module"].items()) and \
            restored["module"].keys() == saved["module"].keys()
        so, ro = saved["optimizer"]["state"], restored["optimizer"]["state"]
        same_opt = so.keys() == ro.keys() and all(
            torch.equal(ro[i][k].cpu(), so[i][k]) for i in so
            for k in so[i])
        emit({"phase": 11, "resume": {
            "restored_step": restored["step"], "first_logged_step":
            new[0]["step"] if new else None, "final_step": resumed.step,
            "module_bit_equal": same_module,
            "optimizer_bit_equal": same_opt}}, log)
        check(restored["step"] == n_steps and new
              and new[0]["step"] == n_steps + 1
              and resumed.step == n_steps + steps_per_epoch,
              "--resume did not continue from the saved step")
        check(same_module and same_opt,
              "--resume did not load the saved tensors bit for bit")

        # Trainer.train_step alone at the same shape, CUDA events
        cfg = get_config("outdoor_ds", overrides).replaced(
            {"trainer": {"steps_per_epoch": steps_per_epoch}})
        trainer = Trainer(cfg, device=dev)
        ds = MegaDepthDataset(root, os.path.join(root, "index",
                                                 "synth_0000.npz"),
                              mode="train", min_overlap_score=0.0,
                              img_resize=size, df=8, img_padding=True,
                              depth_padding=True)
        batch = next(iter(DataLoader(ds, 1, num_workers=1)))[0].to(dev)
        st = trainer.init_state(0)
        trainer.train_step(st, batch)
        step_ms = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            trainer.train_step(st, batch)
            b.record()
            torch.cuda.synchronize()
            step_ms.append(a.elapsed_time(b))
        del st, trainer, state, resumed
        emit({"phase": 11, "nvidia_smi": smi,
              "train_step_ms_events": step_ms,
              "cli_ms_per_step_logger": logger_ms,
              "val_pairs_per_s": [v["pairs"] / v["s"] for v in vals],
              "checkpoint_MiB": [x["MiB"] for x in saves],
              "checkpoint_save_s": [x["s"] for x in saves],
              "peak_mem_MiB": peak}, log)

        # the short accuracy smoke (the small model; its train forward and
        # eval take the plain matcher and fine stack, see SMALL_MODEL)
        reset_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            art = bench.main([
                "--work-dir", os.path.join(root, "synth"),
                "--img-size", "256", "--img-resize", "256",
                "--train-scenes", "2", "--test-scenes", "1", "--views",
                "8", "--steps", "300", "--batch", "4", "--eval-untrained",
                "--depth-format", "npy", "--device", str(dev)])
        smoke_s = time.perf_counter() - t
        res = art["results"]
        emit({"phase": 11, "accuracy_smoke": {
            "train_loss_first20": art["train_loss_first20"],
            "train_loss_last20": art["train_loss_last20"],
            "untrained": res["untrained"], "trained": res["trained"],
            "train_launches": read_counts(), "wall_s": smoke_s}}, log)
        check(art["train_loss_last20"] < 0.25 * art["train_loss_first20"],
              f"accuracy smoke: the loss did not fall below a quarter: "
              f"{art['train_loss_first20']} -> {art['train_loss_last20']}")
        check(res["trained"]["auc@20"] > res["untrained"]["auc@20"],
              f"accuracy smoke: trained auc@20 {res['trained']['auc@20']} "
              f"<= untrained {res['untrained']['auc@20']}")
        emit({"phase": 11, "wall_s": time.perf_counter() - t_phase}, log)
        return counts
    finally:
        (CheckpointManager.save, CheckpointManager.restore,
         Evaluator.evaluate_dataset, Trainer.train_step) = orig
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11")
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
    log = sass = None
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
        sass = sass_start()
        ptxas = ptxas_summary()
        emit({"phase": 1, "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0],
              "kernel_build_s": _build.build_seconds,
              "kernel_load_s": time.perf_counter() - t0,
              "ptxas": ptxas,
              "tf32": "cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False"},
             log)
        # kernels A's and C's register tiles, and those of kernels B's, D's
        # and E's bf16 passes, are sized to fit without spilling
        for src_name in ("coarse_layer.cu", "fine_stage.cu"):
            check(ptxas is None or not any(
                k.startswith(src_name + ":")
                for k in ptxas["spilling_kernels"]),
                f"a kernel of {src_name} spills: {ptxas}")
        for src_name, kern in (("dual_softmax.cu", "dual_softmax_bf16"),
                               ("sinkhorn.cu", "sinkhorn_bf16"),
                               ("focal_loss.cu", "focal_loss_bf16"),
                               ("focal_loss.cu", "focal_grad_bf16"),
                               ("window_attention.cu", "window_attn_bf16"),
                               ("upsample.cu", "upsample2x_band")):
            check(ptxas is None or not any(
                k.startswith(src_name + ":") and kern in k
                for k in ptxas["spilling_kernels"]),
                f"a bf16 pass of {src_name} spills: {ptxas}")
        results = {}
        main_counts = train_counts = ot_counts = cli_counts = None
        with torch.no_grad():  # the inference phases carry no graph
            if 2 in phases:
                kernel_checks(dev, log, results)
                new_kernel_checks(dev, log, results)
                window_upsample_checks(dev, log, results)
            # phase 1's SASS sizes, read while phase 2 ran
            t_s = time.perf_counter()
            emit({"phase": 1, "sass_bytes": sass_sizes(sass),
                  "sass_wait_s": time.perf_counter() - t_s}, log)
            if 3 in phases:
                slice_fp32(dev, log)
            if 4 in phases:
                main_counts, _ = flagship_bf16(dev, log)
            if 7 in phases:
                slice_fp32(dev, log, 7, "indoor_ot", "sinkhorn")
            if 8 in phases:
                ot_counts, ot_matcher = flagship_bf16(
                    dev, log, 8, "indoor_ot", "sinkhorn")
                up_counts, wa_counts = ot_switches(dev, log, ot_matcher)
                del ot_matcher
        if 2 in phases:
            train_kernel_checks(dev, log, results)
        if 5 in phases:
            train_step_fp32(dev, log)
        if 6 in phases:
            train_counts = train_bf16(dev, log)
        if 9 in phases:
            train_ot(dev, log)
        if 10 in phases:
            eval_path(dev, log, smi)
        if 11 in phases:
            cli_counts = train_cli_path(dev, log, smi)
        if results and None not in (main_counts, train_counts, ot_counts):
            pal = "loftr_tpu/ops/pallas/"
            src = {"coarse_layer": ("coarse_layer.cu", "coarse_layer.py:117"),
                   "dual_softmax": ("dual_softmax.cu", "dual_softmax.py:132"),
                   "fine_stage": ("fine_stage.cu", "fine_stage.py:263"),
                   "focal_loss": ("focal_loss.cu", "focal_loss.py:230"),
                   "sinkhorn": ("sinkhorn.cu", "sinkhorn.py:162"),
                   "window_attention": ("window_attention.cu",
                                        "window_attention.py:98"),
                   "upsample": ("upsample.cu", "upsample.py:48")}
            # launches: kernels A, B, C in one match_pair call of
            # indoor_ds; kernel D (forward + backward) in the 8 training
            # steps, where kernel B also runs once a step; kernel E in one
            # match_pair call of indoor_ot (with A x12 and C again);
            # kernels G and F in the two switch runs of phase 8
            launches = {k: main_counts[k] for k in
                        ("coarse_layer", "dual_softmax", "fine_stage")}
            launches["focal_loss"] = (train_counts["focal_loss_forward"]
                                      + train_counts["focal_loss_backward"])
            launches["sinkhorn"] = ot_counts["sinkhorn"]
            launches["upsample"] = up_counts["upsample"]
            launches["window_attention"] = wa_counts["window_attention"]
            extra = {"dual_softmax": {
                         "train_launches": train_counts["dual_softmax"]},
                     "coarse_layer": {
                         "ot_launches": ot_counts["coarse_layer"]},
                     "fine_stage": {"ot_launches": ot_counts["fine_stage"]},
                     "focal_loss": {
                         "launches_forward":
                             train_counts["focal_loss_forward"],
                         "launches_backward":
                             train_counts["focal_loss_backward"]}}
            if cli_counts is not None:
                # phase 11's train CLI run: B and D from its training
                # steps, A, B and C from its validation forwards
                cli_rows = dict(cli_counts, focal_loss=(
                    cli_counts["focal_loss_forward"]
                    + cli_counts["focal_loss_backward"]))
                for name in ("coarse_layer", "dual_softmax", "fine_stage",
                             "focal_loss"):
                    extra.setdefault(name, {})["cli_launches"] = cli_rows[name]
            optional = ("ms_forward", "ms_backward", "peak_mem_MiB",
                        "plain_peak_mem_MiB", "ms_prefilter",
                        "ms_1024_windows", "device_ms_1024_windows",
                        "plain_ms_1024_windows", "bound_ms_1024_windows",
                        "ms_small", "device_ms_small", "plain_ms_small",
                        "bound_ms_small", "library_ms_small",
                        "library", "shape", "device_ms", "ms_cross_B1",
                        "device_ms_cross_B1", "plain_ms_cross_B1",
                        "bound_ms_cross_B1", "variant", "ms_8192",
                        "device_ms_8192", "plain_ms_8192", "bound_ms_8192",
                        "variant_8192", "ms_B8", "device_ms_B8",
                        "plain_ms_B8", "bound_ms_B8", "device_ms_prefilter",
                        "bound_ms_prefilter", "ms_B8_prefilter",
                        "device_ms_B8_prefilter", "device_ms_forward",
                        "device_ms_backward", "bound_ms_two_grid_design",
                        "bound_ms_all_bf16",
                        "bound_ms_f32_products", "bound_ms_forward",
                        "plain_ms_forward", "ms_B2", "ms_forward_B2",
                        "device_ms_B2", "device_ms_forward_B2",
                        "device_ms_backward_B2", "plain_ms_B2",
                        "bound_ms_B2", "peak_mem_MiB_B2")
            kernels = []
            for name, r in results.items():
                kernels.append({
                    "name": name, "route": "cuda",
                    "source": "loftr_tpu_torch/csrc/" + src[name][0],
                    "replaces": pal + src[name][1],
                    "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "bound_unit": r["bound_unit"], **extra.get(name, {}),
                    **{k: r[k] for k in optional if k in r}})
            check(len(kernels) == 7
                  and all(k["launches"] > 0 for k in kernels),
                  f"a kernel was launched no time on its main path: {kernels}")
            print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    finally:
        for p, _ in (sass or {}).values():
            if p.poll() is None:
                p.kill()
                p.wait()
        if log is not None:
            log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
