#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``loftr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2,...,14] [--out FILE]

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
     first two; the FPN merge ``upsample2x_add`` on channels-last maps in
     both dtypes at the four merge sites of the benchmark's batches (coarser
     map [16,256,60,80] and [16,256,120,160] of indoor_ds at B=8,
     [8,256,105,105] and [8,256,210,210] of outdoor_ds at B=4) and at
     [3,196,15,1] and [2,13,1,9], bit-equal in bfloat16 to its plain
     version on the CPU copy, timed at the four sites against the bytes
     bound);
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
     passes and combines); then the backbone at B=8 with the FPN merge
     kernel against the same backbone with the plain merge computed on the
     CPU copy (equal maps, two merge launches), and once at B=1 the fine
     layer stack with ``fused_window_attn`` on against the switch off;
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
     and trained auc@20 exceeds untrained;
 12. the serving path, ``indoor_ds`` bf16 at its published widths with
     seeded random weights (``thr`` 0) and BatchNorm statistics randomised
     from a seed: the model call at 640x480, B=1 and B=8, with the batch
     weights, folded (``fold_batchnorm``) and folded + padded
     (``optimize_variables``), each held to the one before at the bf16
     noise floor (the rule of ``tests/test_torch_slice_bf16.py`` from the
     images), with model and backbone ms (events, profiler); then
     ``MatchingService`` on the folded + padded weights, buckets (480,
     640) and (840, 840), rungs 1, 2, 4, 8, the uint8 wire, ``warmup()``:
     one request equal to ``match_pair`` exactly; 64 requests from 8
     clients in uint8, RGB and float, each held to ``match_pair`` of its
     pair by the near-tie rule, with rungs above 1 in the stats; a
     cancelled future and a starved bucket; pairs/s, p50/p99 latency, the
     phase split and kernel launches per request at 1, 8 and 32 clients
     (128 requests each); one bf16 forward each of the ``group`` norm,
     ``ResNetFPN_16_4`` and ``coarse.attention = "full"``, held to the same
     module with ``use_pallas=False``;
 13. the SfM backend: ``loftr_tpu_torch.sfm.cli.main`` in-process on a
     synthetic ScanNet-layout sequence (60 frames at 640x480, JPEG colour,
     16-bit depth PNGs in mm, cam2world poses, K) with full-width
     ``indoor_ds`` bf16 and seeded random weights, ``--keyframe-stride 5``:
     kernels A, B and C launched once a match call (12 / 1 / 1), the
     report's keys (``sfm.py``'s, with ``ate``), ms a match call, the
     stage times and, when the run finds edges, the host share (tracks and
     problem build), peak memory; ``run_sfm`` on the oracle scene (200 frames, 2000 points,
     stride 5: 40 keyframes, with depth), dense and pcg, on the card and on
     the CPU with the same RANSAC draws: JAX's ATE bars on both, camera
     centres within 1e-3 after a Sim(3) alignment whose scale is within
     1e-4 of 1, stage times; BA at keyframe scale (C = 300, P =
     100,000, O = 8, noise 1e-3): one ``ba_iteration`` dense and pcg
     against the CPU (costs within 1e-5, poses and points no further from
     the float64 step than twice the CPU's float32 step), ms and device ms
     per LM iteration, launches per iteration, peak memory; full
     ``bundle_adjust`` below 3 M noise^2, twice with equal bits;
     ``reset_point_outliers`` with 2% of the points dragged: the card's
     gates equal the CPU's, at least 95% of the planted outliers zeroed and
     no more good observations than the noise's tail puts beyond the gate
     (bar 10, ~3 expected).
 14. the parallel modules, on the one card: two ranks of a gloo group
     (processes of this script, ``--rank``), the port's collectives on the
     card's tensors, the all-gather and the ring staged through host memory
     (gloo carries only broadcast and all-reduce for CUDA tensors; the
     phase prints how often): the ``indoor_ds`` data-parallel
     ``Trainer.train_step`` at 640x480, global B = 2 with one row a rank,
     in float32 (TF32 off) and bf16, against the one-process B = 2 step
     with the same weights and noise (losses, gradient norm, parameters
     and running statistics, float32 at phase 5's bars; the summed
     gradients reported; the ranks bit-equal; kernels B and D once a
     rank), bf16 ms a step; one sharded BA
     iteration at C = 300 / P = 100,000 / O = 8, dense and pcg, against
     the one-process ``ba_iteration`` (costs within 1e-5, no further from
     float64 than twice its step, cameras bit-equal across the ranks); the
     token-sharded coarse stack at L = S = 4800 (float32), linear and
     full, against the unsharded plain stack (1e-4 of the largest
     output); the evaluator's merge of the two ranks' pairs against one
     process (equal); then one NCCL rank: ``Trainer(group=...)``'s step
     equal bit for bit to the step without a group, under deterministic
     algorithms; then ``MatchingService(mesh=...)`` with a one-device
     mesh: a rung-1 response equal to ``match_pair``, 16 requests from 4
     clients held to it as phase 12 holds them.  Every item prints the
     card's name and power limit.
Each main path (one ``match_pair`` call of each preset; the 8 training
steps; the two switch runs; the CLI's ``batched`` run; the train CLI's
first run; the service's 64 requests; the SfM CLI's run) runs with every
kernel launch counter set to 0 just before it; the counts read just after
it must show every kernel of that path.  ``--phases 5,6`` runs only the
indoor_ds training, ``--phases 10`` only the evaluation path, ``--phases
11`` only the training CLI, ``--phases 13`` only the SfM backend.  Results go
to stdout one JSON object per line; the line before the last is the kernel
summary, and the last line is the contract line ``{"ok": true, "device":
{...}}``.  Without CUDA, or without the package beside this script, it exits
with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import copy
import json
import math
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


def device_ms(fn, iters=10, tries=3, per_launch=False):
    """Device time per call of ``fn`` from the profiler, by kernel, with the
    sum under "total"; None when the profiler sees no device time in any of
    ``tries`` windows (a window now and then records no kernel at all).
    Late in a long process a window loses some of its kernel records (6-8
    of 10 launches of the merge kernel; 1-2% of a many-kernel call's), so
    such a sum reads low.  With ``per_launch`` each kernel's time is the
    mean of its own records, which lost records leave unbiased: the time a
    call of an ``fn`` that launches each of its kernels once."""
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
                n = e.count if per_launch else iters
                per[name] = per.get(name, 0.0) + t / n / 1e3
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
                          r"upsample2x_band|upsample2x_kernel|"
                          r"upsample2x_add_nhwc)I(\w+?)EEv",
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


def merge_checks(dev, log, results):
    """The FPN merge kernel (``upsample2x_add``: lateral + x2 upsample of
    the coarser map, channels-last) against its plain version on the CPU
    copy of the inputs, at the four merge sites of the benchmark's batches
    and two ragged shapes, and its times at the four sites.  Its row of the
    kernels line is the indoor_ds 1/2 site in bf16 (the match_b8 cell's
    largest merge)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from loftr_tpu_torch.ops.kernels import upsample as KG

    rng = np.random.RandomState(13)
    f32, bf16 = torch.float32, torch.bfloat16
    cl = torch.channels_last
    # coarser map [B, C, H, W] of each site: indoor_ds at B=8 (16 images,
    # 640x480), outdoor_ds at B=4 (8 images, 840x840), the 1/4 and the 1/2
    # merge; then C = 196 (4 channels a thread) with W = 1 and C = 13 (one
    # value a thread) with H = 1
    sites = {"indoor_ds_quarter": (16, 256, 60, 80),
             "indoor_ds_half": (16, 256, 120, 160),
             "outdoor_ds_quarter": (8, 256, 105, 105),
             "outdoor_ds_half": (8, 256, 210, 210)}
    # tolerances: bfloat16 -- none, the same float sums rounded at the same
    # places; float32 -- two-term float sums, fused or not (kernel G's)
    tol = {f32: 1e-6, bf16: 0.0}
    times, err = {}, {}
    for name, shp in [*sites.items(), ("ragged_w1", (3, 196, 15, 1)),
                      ("ragged_h1", (2, 13, 1, 9))]:
        b, c, h, w = shp
        x = rng.randn(*shp).astype(np.float32)
        lat = rng.randn(b, c, 2 * h, 2 * w).astype(np.float32)
        for dt in (f32, bf16):
            xt = torch.from_numpy(x).to(dt).to(dev, memory_format=cl)
            lt = torch.from_numpy(lat).to(dt).to(dev, memory_format=cl)
            got = KG.upsample2x_add(lt, xt)
            card = KG.upsample2x_add_plain(lt, xt)
            torch.cuda.synchronize()
            want = KG.upsample2x_add_plain(lt.cpu(), xt.cpu()).to(dev)
            d = (got.float() - want.float()).abs()
            bound = tol[dt] * (1 + want.float().abs())
            ok = (got.shape == want.shape and got.dtype == dt
                  and got.is_contiguous(memory_format=cl)
                  and bool((d <= bound).all()))
            rec = {"phase": 2, "kernel": "upsample_add", "site": name,
                   "shape": list(shp), "dtype": str(dt)[6:],
                   "max_abs_err": float(d.max()),
                   "unequal": int((d > 0).sum()),
                   "max_abs_diff_from_plain_on_card":
                       float((got.float() - card.float()).abs().max()),
                   "plain_on_card_unequal": int((card != want).sum()),
                   "tol": tol[dt], "ok": ok}
            emit(rec, log)
            check(ok, f"upsample_add disagrees: {rec}")
            err[(name, dt)] = rec["max_abs_err"]
            del got, card, want, d, bound
        if name in sites:
            def run():
                return KG.upsample2x_add(lt, xt)
            dms = device_ms(run, per_launch=True) or {}
            n = b * c * h * w           # coarser map; lateral and sum 4n
            bnd, by = bound_ms(4 * n * 10, 9 * n * 2, PEAK_F32_FLOPS)
            times[name] = dict(
                ms=cuda_ms(run, iters=20), device_ms=dms.get("total"),
                variant=sorted(k for k in dms if k != "total"),
                plain_ms=cuda_ms(lambda: KG.upsample2x_add_plain(lt, xt),
                                 iters=10),
                library_ms=cuda_ms(lambda: lt + F.interpolate(
                    xt, scale_factor=2, mode="bilinear", align_corners=True),
                    iters=10),
                bound_ms=bnd, bound_by=by)
            t = times[name]
            if t["device_ms"] is not None and t["device_ms"] < bnd:
                # a device time under the bytes bound is no reading
                t["device_ms_invalid"], t["device_ms"] = t["device_ms"], None
            t["device_over_bound"] = (None if t["device_ms"] is None
                                      else t["device_ms"] / bnd)
        del xt, lt
        torch.cuda.empty_cache()
    emit({"phase": 2, "kernel": "upsample_add", "timing": times,
          "bound": "lateral and sum once, the coarser map once (bytes; "
                   "device memory); 10 flop an output (float32 rate)",
          "library": "lateral + torch.nn.functional.interpolate("
                     "scale_factor=2, mode='bilinear', align_corners=True)"},
         log)
    t = times["indoor_ds_half"]
    results["upsample_add"] = dict(
        max_abs_err=err[("indoor_ds_half", bf16)], ms=t["ms"],
        device_ms=t["device_ms"], variant=t["variant"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        bound_unit="device memory",
        library="lateral + torch.nn.functional.interpolate(scale_factor=2, "
                "mode='bilinear', align_corners=True)",
        shape="coarser map [16,256,120,160], lateral [16,256,240,320], "
              "channels-last bf16 (the other sites under 'sites'; checked "
              "there and at [3,196,15,1], [2,13,1,9])",
        sites={k: v for k, v in times.items() if k != "indoor_ds_half"})


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
    expect_counts(counts, coarse_layer=12, fine_stage=1, upsample_add=2,
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
                  upsample_add=2, **{matcher_kernel: 1})

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

def train_batch(seed, batch, hw=(H, W)):
    """A seeded training batch: random images, depth in [1, 3], identity
    pose and a pinhole K, so the coarse ground truth is the diagonal."""
    import numpy as np
    import torch
    from loftr_tpu_torch.structs import MatchInput
    h, w = hw
    rng = np.random.RandomState(seed)
    K = np.array([[[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]]] * batch,
                 np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    t = torch.from_numpy
    return MatchInput(
        image0=t(rng.rand(batch, h, w, 1).astype(np.float32)),
        image1=t(rng.rand(batch, h, w, 1).astype(np.float32)),
        depth0=t((rng.rand(batch, h, w) * 2 + 1).astype(np.float32)),
        depth1=t((rng.rand(batch, h, w) * 2 + 1).astype(np.float32)),
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
    worst, far, stat_err, stat_key = _moved_apart(
        card["after"], cpu["after"], cpu["before"], lr)
    moved = max(float((a - card["before"][k]).abs().max())
                for k, a in card["after"].items()
                if not k.endswith(("num_batches_tracked", "running_mean",
                                   "running_var")))
    rec = {"phase": 5, "scalars_card": card["scalars"],
           "scalars_cpu": cpu["scalars"], "rel_err": rel,
           "param_max_abs_diff": worst, "lr": lr,
           "param_frac_beyond_half_lr": far,
           "param_max_update": moved, "running_stat_max_rel_err": stat_err,
           "running_stat_worst": stat_key,
           "card_step_s": card["seconds"], "cpu_step_s": cpu["seconds"],
           "launches": card["counts"]}
    # tolerances: the losses are means over millions of float terms in
    # another order (1e-3); the gradient norm also carries ReLU-mask flips
    # between two float32 convolution libraries (2e-2)
    rec["ok"] = (rel["loss"] <= 1e-3 and rel["loss_c"] <= 1e-3
                 and rel["loss_f"] <= 1e-3 and rel["grad_norm"] <= 2e-2
                 and worst <= 2.2 * lr and far <= 0.05
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
    """The backbone at B=8 with the FPN merge kernel against the same
    backbone with the plain merge computed on the CPU copy of its operands,
    and the fine layer stack with ``fused_window_attn`` on followed by
    ``fine_match`` once at B=1 against the switch off, each with the launch
    counters reset just before.  Returns the launch counts of the two
    runs."""
    import torch
    import loftr_tpu_torch.models.backbone as BB
    from loftr_tpu_torch.api import with_config
    from loftr_tpu_torch.models.transformer import LocalFeatureTransformer
    from loftr_tpu_torch.ops.fine_match import fine_match
    from loftr_tpu_torch.ops.kernels import upsample as KG
    from loftr_tpu_torch.structs import MatchInput

    model = with_config(matcher, {"dtype": "bfloat16"})
    a, b = images(4, 8)
    inp8 = MatchInput(image0=torch.from_numpy(a[..., None]).to(dev),
                      image1=torch.from_numpy(b[..., None]).to(dev))
    model.extract(inp8)                                      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    on = model.extract(inp8)
    torch.cuda.synchronize()
    up_counts = read_counts()
    t_on = cuda_ms(lambda: model.extract(inp8))
    merge = BB._merge
    sites = []

    def cpu_merge(outconv, x, coarse, train):
        # the plain merge on the CPU, where its products sum in float32
        sites.append(list(coarse.shape))
        lateral = BB.apply_conv(outconv, x)
        return KG.upsample2x_add_plain(lateral.cpu(), coarse.cpu()).to(
            lateral.device, memory_format=torch.channels_last)

    def card_merge(outconv, x, coarse, train):
        # the plain merge on the card, as before the kernel
        return KG.upsample2x_add_plain(BB.apply_conv(outconv, x), coarse)
    try:
        BB._merge = cpu_merge
        ref = model.extract(inp8)
        BB._merge = card_merge
        card = model.extract(inp8)
        t_card = cuda_ms(lambda: model.extract(inp8))
    finally:
        BB._merge = merge
    expect_counts(up_counts, upsample_add=2)
    rec = {"phase": 8, "part": "backbone FPN merge kernel, B=8",
           "launches": up_counts, "merge_sites": sites,
           "extract_ms_kernel": t_on, "extract_ms_plain_merge": t_card}
    # the kernel's maps equal those of the plain merge on the CPU copy bit
    # for bit (the convolutions after it see the same inputs); against the
    # plain merge on the card, where cuBLAS may round a few outputs
    # otherwise, the distance is reported and held to the bf16 noise of
    # two 3x3 convolutions
    ok = len(sites) == 2
    for name in ("feat_c0", "feat_c1", "feat_f0", "feat_f1"):
        x, y = getattr(on, name), getattr(ref, name)
        z = getattr(card, name).float()
        d = (x.float() - z).abs()
        rec[name + "_equal_to_cpu_merge"] = bool(torch.equal(x, y))
        rec[name + "_max_abs_diff_plain_on_card"] = float(d.max())
        rec[name + "_max_abs"] = float(z.abs().max())
        ok = ok and bool(torch.equal(x, y)) \
            and float(d.max()) <= 2 ** -5 * float(z.abs().max()) \
            and float(d.mean()) <= 1e-3 * float(z.abs().max())
    rec["ok"] = ok
    emit(rec, log)
    check(ok, f"backbone with the merge kernel disagrees: {rec}")
    del on, ref, card, inp8

    a, b = images(4, 1)
    inp = MatchInput(image0=torch.from_numpy(a[..., None]).to(dev),
                     image1=torch.from_numpy(b[..., None]).to(dev))
    off = model.extract(inp)

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
                      dual_softmax=n_pairs, fine_stage=n_pairs,
                      upsample_add=2 * n_pairs)

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
                      focal_loss_backward=n_steps,
                      upsample_add=2 * 2 * n_val)
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


# --------------------------------------------------------------------------
# phase 12: the serving path: weight transforms, MatchingService, options
# --------------------------------------------------------------------------

def images_hw(seed, h, w):
    """One seeded pair at (h, w), built as ``images`` builds them."""
    import numpy as np
    rng = np.random.RandomState(seed)
    base = rng.rand(h // 8 + 8, w // 8 + 8)
    big = np.kron(base, np.ones((8, 8)))
    big = (big + np.roll(big, 4, 0) + np.roll(big, 4, 1)) / 3
    sh = np.clip(big[13:13 + h, 21:21 + w] + 0.05 * rng.randn(h, w), 0, 1)
    return ((big[:h, :w] * 255).astype(np.uint8), (sh * 255).astype(np.uint8))


def _match_keys(res, wc):
    """A response's matches by (i, j) coarse cell -> mconf: mkpts0 is the
    coarse point of cell i (scale 1), mkpts1 the coarse point of cell j
    moved by at most half a window (2 x 2 px), so j's coordinates are the
    nearest multiples of 8."""
    import numpy as np
    k0 = np.round(res["mkpts0"] / 8.0).astype(int)
    k1 = np.round(res["mkpts1"] / 8.0).astype(int)
    return {(int(a[1] * wc + a[0]), int(b[1] * wc + b[0])): float(c)
            for a, b, c in zip(k0, k1, res["mconf"])}


def hold_responses(got, want, want32, conf, wc, moved=None):
    """Responses of one pair against ``match_pair`` of that pair by the
    near-tie rule of tests/test_torch_slice_bf16.py: the valid sets agree
    but for cells whose top-2 gap (``rel_gap_top2`` of the pair's
    confidence matrix, along the row or the column) is within one bf16 ulp
    (2^-7 relative); and over all responses the mean |mconf| difference on
    the matches both hold is no larger than the bf16 noise floor (``want``
    against its float32 twin ``want32``).

    ``moved`` (one entry a response, or None) widens the gap for a
    response whose rung gives the backbone other bits: the (row, column)
    maxima of |conf at the response's rung - conf|.  A row's best column
    can change only where its absolute top-2 gap is within twice its
    row's move (a column's likewise), so a cell is also a near tie there;
    every other cell's membership is still compared.  Returns (odd
    matches, the mconf differences, the floor's differences, the cells
    that only the move excused, and per moved response the share of rows
    whose gap the move covers)."""
    row_gap = rel_gap_top2(conf).cpu().numpy()
    col_gap = rel_gap_top2(conf.transpose(0, 1)).cpu().numpy()
    top_r = conf.topk(2, dim=1).values
    top_c = conf.topk(2, dim=0).values
    row_abs = (top_r[:, 0] - top_r[:, 1]).cpu().numpy()
    col_abs = (top_c[0] - top_c[1]).cpu().numpy()
    wm, w32 = _match_keys(want, wc), _match_keys(want32, wc)
    odd, errs, excused, covered = [], [], 0, []
    for idx, res in enumerate(got):
        gm = _match_keys(res, wc)
        mv = moved[idx] if moved else None
        if mv is not None:
            covered.append(float((row_abs <= 2 * mv[0]).mean()))
        for m in set(gm) ^ set(wm):
            if min(row_gap[m[0]], col_gap[m[1]]) <= 2.0 ** -7:
                continue
            if mv is not None and (row_abs[m[0]] <= 2 * mv[0][m[0]]
                                   or col_abs[m[1]] <= 2 * mv[1][m[1]]):
                excused += 1
                continue
            odd.append(m)
        errs += [abs(gm[m] - wm[m]) for m in set(gm) & set(wm)]
    floor = [abs(wm[m] - w32[m]) for m in set(wm) & set(w32)]
    return odd, errs, floor, excused, covered


def conv_batch_witness(model, p0, p1, n, dev):
    """Where a batch row's backbone bits depend on the batch size.  The
    pair alone (the backbone takes N = 2 images) against the pair repeated
    to a batch of ``n`` (N = 2n), on the coarse map's first row:
    (1) each convolution call of the B=1 forward, given its own input
    repeated to N = 2n: the calls whose first rows change bits (cuDNN
    picks its algorithm by shape); (2) the batch-``n`` forward with every
    convolution run in chunks of 2 images (the B=1 call's N): equal to the
    B=1 bits exactly when the convolutions' batch size is the backbone's
    only dependence on the batch; (3) for the record, whether cuDNN's
    deterministic mode (benchmark off) gives the two batch sizes the same
    bits."""
    import numpy as np
    import torch
    import loftr_tpu_torch.models.backbone as bbm
    from loftr_tpu_torch.structs import MatchInput

    def coarse(k):
        t = lambda a: torch.from_numpy(np.repeat(
            a[None, :, :, None], k, 0) / np.float32(255)).to(dev)
        return model.extract(MatchInput(image0=t(p0), image1=t(p1))
                             ).feat_c0[0]

    orig = bbm.apply_conv
    calls = []

    def record(m, x):
        y = orig(m, x)
        calls.append((m, x, y))
        return y
    with torch.no_grad():
        bbm.apply_conv = record
        try:
            f1 = coarse(1)
        finally:
            bbm.apply_conv = orig
        variant = []
        for idx, (m, x, y) in enumerate(calls):
            d = (orig(m, x.repeat_interleave(n, 0))[::n] - y).float().abs()
            if bool((d > 0).any()):
                variant.append({"call": idx, "in": m.in_channels,
                                "out": m.out_channels, "k": m.kernel_size[0],
                                "stride": m.stride[0],
                                "hw_in": list(x.shape[2:]),
                                "max_abs_diff": float(d.max())})
        n_calls = len(calls)
        del calls
        fn = coarse(n)
        bbm.apply_conv = lambda m, x: torch.cat(
            [orig(m, c) for c in x.split(2)])
        try:
            fc = coarse(n)
        finally:
            bbm.apply_conv = orig
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=True,
                allow_tf32=torch.backends.cudnn.allow_tf32):
            det = torch.equal(coarse(n), coarse(1))
    return {"batch": n, "conv_calls": n_calls,
            "batch_variant_convs": variant,
            "same_bits": torch.equal(fn, f1),
            "same_bits_convs_at_b1_batch": torch.equal(fc, f1),
            "same_bits_cudnn_deterministic": det}


def _stage_fields(model, inp):
    """(coarse map, valid, i, j, mconf, expec_f, fine map) of one model
    call."""
    f = model.extract(inp)
    out = model(inp)
    return (f.feat_c0.float(), out.valid, out.coarse.i_ids,
            out.coarse.j_ids, out.coarse.mconf.float(), out.expec_f.float(),
            f.feat_f0.float())


def _by_match(f):
    """(b, i, j) -> (mconf, expec_f) of a model call's valid matches."""
    import numpy as np
    v = f[1].cpu().numpy()
    ii, jj = f[2].cpu().numpy(), f[3].cpu().numpy()
    conf, e = f[4].cpu().numpy(), f[5].cpu().numpy()
    return {(b, int(ii[b, s]), int(jj[b, s])): (conf[b, s], e[b, s])
            for b, s in zip(*np.nonzero(v))}


def hold_model(got, want, want32):
    """A bf16 model call against another bf16 call of the same function
    from the same images (the kernels against the plain path): the coarse
    map's mean difference no larger than ``want``'s to its float32 twin
    ``want32``; on the matches the three share (as sets: near-equal mconf
    values may trade top-K slots), ``got``'s mean mconf and expec_f errors
    to ``want32`` within twice ``want``'s (two bf16 roundings of one
    function, the factor tests/test_torch_slice_bf16.py gives expec_f)."""
    import numpy as np
    g, w, w32 = _by_match(got), _by_match(want), _by_match(want32)
    shared = sorted(set(g) & set(w) & set(w32))
    d = {"map_err": float((got[0] - want[0]).abs().mean()),
         "map_floor": float((want[0] - want32[0]).abs().mean()),
         "matches": [len(g), len(w), len(w32)], "shared": len(shared)}
    if shared:
        def err(a, b, i):
            return float(np.mean([np.abs(a[m][i] - b[m][i]).mean()
                                  for m in shared]))
        d.update(mconf_err=err(g, w32, 0), mconf_floor=err(w, w32, 0),
                 expec_err=err(g, w32, 1), expec_floor=err(w, w32, 1))
    ok = (len(shared) > 0 and d["map_err"] <= d["map_floor"]
          and d["mconf_err"] <= 2 * d["mconf_floor"]
          and d["expec_err"] <= 2 * d["expec_floor"])
    return ok, d


def hold_transform(models, inp):
    """The weight transforms keep the function.  In float32 (TF32 off), on
    the plain matcher so that the confidence matrix exists: the folded
    model against the batch one and the padded against the folded at
    tests/test_folding.py's bars (backbone maps 5e-4; conf rtol 1e-3 /
    atol 1e-4; expec_f 1e-3 on the slots both select; mkpts0_f 5e-3).  In
    bfloat16 (the served path): folding and padding round at other places
    than the batch model, so each model's dense backbone maps are held to
    the float32 batch model at twice the batch bf16 model's own distance
    to it (the factor tests/test_torch_slice_bf16.py gives expec_f).
    Matches are compared as sets: near-equal mconf values may trade top-K
    slots."""
    import numpy as np
    from loftr_tpu_torch.api import with_config
    plain = {"dtype": "float32", "match_coarse": {"use_pallas": False},
             "fine": {"use_pallas": False}}
    res = {}
    f32 = {}
    for k, m in models.items():
        mm = with_config(m, plain)
        f = mm.extract(inp)
        o = mm(inp)
        f32[k] = (f.feat_c0, f.feat_f0, o)
    ok = True
    for a, b in (("folded", "batch"), ("folded_padded", "folded")):
        (ca, fa, oa), (cb, fb, ob) = f32[a], f32[b]

        def by_match(o):        # (b, i, j) -> (expec_f, mkpts0_f), valid
            v = o.valid.cpu().numpy()
            ii, jj = o.coarse.i_ids.cpu().numpy(), o.coarse.j_ids.cpu().numpy()
            e, k = o.expec_f.cpu().numpy(), o.mkpts0_f.cpu().numpy()
            return {(bb, int(ii[bb, s]), int(jj[bb, s])): (e[bb, s], k[bb, s])
                    for bb, s in zip(*np.nonzero(v))}
        ma, mb = by_match(oa), by_match(ob)
        shared = set(ma) & set(mb)
        r = {"coarse_map_excess": float(((ca - cb).abs()
                                         - 5e-4 * cb.abs()).max()),
             "fine_map_excess": float(((fa - fb).abs()
                                       - 5e-4 * fb.abs()).max()),
             "conf_excess": float(((oa.conf_matrix - ob.conf_matrix).abs()
                                   - 1e-3 * ob.conf_matrix.abs()).max()),
             "matches_shared": len(shared) / max(1, len(mb)),
             "expec_f_max": max((float(np.abs(ma[m][0] - mb[m][0]).max())
                                 for m in shared), default=None),
             "mkpts0_f_max": max((float(np.abs(ma[m][1] - mb[m][1]).max())
                                  for m in shared), default=None)}
        r["ok"] = (r["coarse_map_excess"] <= 5e-4
                   and r["fine_map_excess"] <= 5e-4
                   and r["conf_excess"] <= 1e-4
                   and r["matches_shared"] >= 0.9
                   and r["expec_f_max"] <= 1e-3
                   and r["mkpts0_f_max"] <= 5e-3)
        res[f"f32_{a}_vs_{b}"] = r
        ok = ok and r["ok"]
    c32, f32b = f32["batch"][0], f32["batch"][1]
    floor = None
    for k, m in models.items():
        f = m.extract(inp)
        e = (float((f.feat_c0.float() - c32).abs().mean()),
             float((f.feat_f0.float() - f32b).abs().mean()))
        if k == "batch":
            floor = e
        res[f"bf16_{k}_to_f32"] = {"coarse_map_err": e[0],
                                   "fine_map_err": e[1]}
        ok = ok and e[0] <= 2 * floor[0] and e[1] <= 2 * floor[1]
    return ok, res


def serve_path(dev, log, hw=(H, W), hw_big=(840, 840)):
    """Phase 12 at the buckets ``hw`` and ``hw_big``.  Returns the launch
    counts of the service's mixed run."""
    import threading
    import numpy as np
    import torch
    from concurrent.futures import CancelledError
    from loftr_tpu_torch.api import (load_matcher, match_pair,
                                     optimize_variables, with_config)
    from loftr_tpu_torch.models.matcher import LoFTR
    from loftr_tpu_torch.config import get_config
    from loftr_tpu_torch.serve import MatchingService
    from loftr_tpu_torch.serve.service import _to_gray
    from loftr_tpu_torch.structs import MatchInput
    from loftr_tpu_torch.utils.folding import fold_batchnorm
    from loftr_tpu_torch.utils.weights import init_weights

    t_phase = time.perf_counter()
    thr0 = {"match_coarse": {"thr": 0.0}}
    base = load_matcher(seed=0, device=dev)
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for m in base.backbone.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
    sd = {k: v.detach().cpu() for k, v in base.state_dict().items()}
    weights = {"batch": sd, "folded": fold_batchnorm(sd),
               "folded_padded": optimize_variables(sd)}
    models = {k: with_config(load_matcher(device=dev, state_dict=v),
                             {"dtype": "bfloat16", **thr0})
              for k, v in weights.items()}
    check(models["folded_padded"].config.backbone.block_dims
          == (128, 256, 256)
          and models["folded"].config.backbone.norm == "none",
          "transformed weights did not set the backbone config")

    # 1. transforms: batch, folded, folded + padded at B=1 and B=8
    for B in (1, 8):
        a, b = (np.stack(x) for x in zip(*(images_hw(5 + k, *hw)
                                             for k in range(B))))
        inp = MatchInput(
            image0=torch.from_numpy(a[..., None] / np.float32(255)).to(dev),
            image1=torch.from_numpy(b[..., None] / np.float32(255)).to(dev))
        rec = {"phase": 12, "transforms_batch": B}
        for name, m in models.items():
            rec[name] = {
                "model_ms": cuda_ms(lambda: m(inp)),
                "backbone_ms": cuda_ms(lambda: m.extract(inp)),
                "model_device_ms": (device_ms(lambda: m(inp)) or {}).get(
                    "total"),
                "backbone_device_ms": (device_ms(lambda: m.extract(inp))
                                       or {}).get("total")}
        if B == 1:   # the function check; B=8 adds only timings
            rec["ok"], rec["hold"] = hold_transform(models, inp)
        emit(rec, log)
        check(rec.get("ok", True), f"transformed weights disagree: {rec}")

    # 2. the service on the folded + padded weights
    fast = models["folded_padded"]
    svc = MatchingService(weights["folded_padded"], overrides={
        "loftr": thr0}, buckets=(hw, hw_big),
        batch_sizes=(1, 2, 4, 8), flush_ms=5.0, wire_dtype="uint8",
        device=dev)
    try:
        t0 = time.perf_counter()
        svc.warmup()
        warm_s = time.perf_counter() - t0
        pairs = [images_hw(20 + k, *(hw if k < 4 else hw_big))
                 for k in range(8)]
        oracle = [(match_pair(p0, p1, fast),
                   match_pair(p0, p1, fast, dtype="float32"))
                  for p0, p1 in pairs]
        # one request through match(): rung 1, equal to match_pair exactly
        one = svc.match(*pairs[0])
        exact = all(np.array_equal(one[k], oracle[0][0][k]) for k in one)
        emit({"phase": 12, "service_one_request_exact": exact,
              "n_matches": int(one["mconf"].shape[0]),
              "warmup_s": warm_s}, log)
        check(exact and one["mconf"].shape[0] > 0,
              "a rung-1 response differs from match_pair")

        # 64 requests from 8 clients, two buckets, three formats
        def fmt(img, k):
            if k % 3 == 1:
                return np.repeat(img[..., None], 3, axis=-1)     # RGB
            if k % 3 == 2:
                return img.astype(np.float32) / 255.0            # float
            return img                                           # uint8
        for k, (p0, p1) in enumerate(pairs):
            for f in range(3):
                check(np.array_equal(_to_gray(fmt(p0, f), np.uint8), p0),
                      "a request format changes the wire image")
        svc.stats.reset()
        results = [None] * 64
        torch.cuda.synchronize()
        reset_counts()

        def client(c):
            for r in range(c, 64, 8):
                p0, p1 = pairs[r % 8]
                results[r] = svc.submit(fmt(p0, r), fmt(p1, r // 3)
                                        ).result(timeout=300)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        serve_counts = read_counts()
        snap = svc.stats.snapshot()
        # each response against the direct model call on its pair at its
        # rung (the pair in every row): equal exactly at one rung, since a
        # batch row's outputs depend on the batch's shape, not on the
        # other rows; and against match_pair (rung 1) by the near-tie rule
        plain = with_config(fast, {"match_coarse": {"use_pallas": False}})

        def batch_of(p0, p1, n):
            return MatchInput(
                image0=torch.from_numpy(np.repeat(
                    p0[None, :, :, None], n, 0) / np.float32(255)).to(dev),
                image1=torch.from_numpy(np.repeat(
                    p1[None, :, :, None], n, 0) / np.float32(255)).to(dev))
        held, rung_of, cross, witness = {}, [None] * 64, {}, {}
        for k, (p0, p1) in enumerate(pairs):
            big = k >= 4
            name = "big" if big else "small"
            direct = {}
            for n in svc.batch_sizes:
                inp = batch_of(p0, p1, n)
                out = fast(inp)
                keep = out.valid[0].cpu().numpy()
                direct[n] = {
                    "mkpts0": out.mkpts0_f[0].float().cpu().numpy()[keep],
                    "mkpts1": out.mkpts1_f[0].float().cpu().numpy()[keep],
                    "mconf": out.coarse.mconf[0].float().cpu().numpy()[keep]}
                if k in (0, 4):      # the backbone across rungs, per bucket
                    f = fast.extract(inp).feat_c0[0].float()
                    if n == 1:
                        f1 = f
                        f32 = with_config(fast, {"dtype": "float32"}).extract(
                            inp).feat_c0[0].float()
                        cross[name] = {"bf16_to_f32_mean_abs_diff": float(
                            (f1 - f32).abs().mean())}
                    d = (f - f1).abs()
                    cross[name][n] = {
                        "coarse_map_max_abs_diff": float(d.max()),
                        "coarse_map_mean_abs_diff": float(d.mean()),
                        "share_differing": float((d > 0).float().mean())}
            if k in (0, 4):
                witness[name] = conv_batch_witness(fast, p0, p1, 2, dev)
            check(all(np.array_equal(direct[1][x], oracle[k][0][x])
                      for x in direct[1]),
                  "the direct B=1 call differs from match_pair")
            for r in range(k, 64, 8):
                rung_of[r] = next((n for n in svc.batch_sizes if all(
                    np.array_equal(results[r][x], direct[n][x])
                    for x in direct[n])), None)
            conf = plain(batch_of(p0, p1, 1)).conf_matrix[0].float()
            rs = list(range(k, 64, 8))
            moved = None
            if big:
                # the (840, 840) bucket: cuDNN's algorithm for B >= 2
                # differs from B=1's (the witness), so each response's
                # near ties are widened by its own rung's measured move
                by_rung = {}
                for n in {rung_of[r] for r in rs} - {None, 1}:
                    dc = (plain(batch_of(p0, p1, n)).conf_matrix[0].float()
                          - conf).abs()
                    by_rung[n] = (dc.amax(1).cpu().numpy(),
                                  dc.amax(0).cpu().numpy())
                    del dc
                moved = [by_rung.get(rung_of[r]) for r in rs]
            held[k] = hold_responses([results[r] for r in rs], *oracle[k],
                                     conf, p0.shape[1] // 8, moved)
            del conf
        by_bucket = {}
        for name, ks in (("small", range(4)), ("big", range(4, 8))):
            errs = [e for k in ks for e in held[k][1]]
            floor = [e for k in ks for e in held[k][2]]
            rs = [r for r in range(64) if r % 8 in ks]
            by_bucket[name] = {
                "rungs": {str(n): sum(rung_of[r] == n for r in rs)
                          for n in svc.batch_sizes},
                "exact_at_its_rung": sum(rung_of[r] is not None for r in rs),
                "odd_matches": sum(len(held[k][0]) for k in ks),
                "excused_by_measured_move": sum(held[k][3] for k in ks),
                "rows_covered_by_move": float(np.mean(
                    [c for k in ks for c in held[k][4]] or [0.0])),
                "matches_both": len(errs),
                "mconf_err": float(np.mean(errs)) if errs else None,
                "mconf_floor": float(np.mean(floor)) if floor else None,
                "backbone_across_rungs": cross[name],
                "witness": witness[name]}
            b = by_bucket[name]
            rungs = [v for n, v in cross[name].items() if n != 1
                     and isinstance(v, dict)]
            b["mconf_within_floor"] = (b["matches_both"] > 0
                                       and b["mconf_err"] <= b["mconf_floor"])
            b["maps_within_floor"] = all(
                v["coarse_map_mean_abs_diff"]
                <= cross[name]["bf16_to_f32_mean_abs_diff"] for v in rungs)
            # the near-tie rule (with the measured move at (840, 840)); the
            # moved maps no further apart than bf16 from float32; and the
            # backbone's only dependence on the batch the convolutions'
            # batch size
            b["near_tie_rule"] = (b["odd_matches"] == 0
                                  and b["mconf_within_floor"]
                                  and b["maps_within_floor"] and b["witness"][
                                      "same_bits_convs_at_b1_batch"])
        rec = {"phase": 12, "main_path": "MatchingService 64 requests, 8 "
               "clients, two buckets, uint8/RGB/float",
               "buckets": [list(hw), list(hw_big)],
               "launches": serve_counts, "stats": snap,
               "rungs_above_1": sorted(k for k in snap["batch_hist"]
                                       if k > 1),
               "held": by_bucket}
        emit(rec, log)
        check(all(n is not None for n in rung_of),
              f"a response equals the direct call at no rung: {by_bucket}")
        check(all(b["near_tie_rule"] for b in by_bucket.values()),
              f"service responses disagree with match_pair: {by_bucket}")
        check(rec["rungs_above_1"], "the service never batched above 1")
        check(min(serve_counts[k] for k in ("coarse_layer", "dual_softmax",
                                            "fine_stage")) > 0,
              f"the service's path missed a kernel: {serve_counts}")

        # 3. a cancelled future and a starved bucket
        orig = svc._launch

        def slow(s):
            def f(inp):
                time.sleep(s)
                return orig(inp)
            return f
        svc._launch = slow(0.2)
        doomed = svc.submit(*pairs[0])
        cancelled = doomed.cancel()
        rest = [svc.submit(*pairs[1]) for _ in range(3)]
        for f in rest:
            f.result(timeout=120)
        with svc._lock:
            busy = svc._busy
        svc._launch = slow(0.25)
        svc.max_hold_s = 0.05
        flood = []

        def feeder():
            for _ in range(10):
                flood.extend(svc.submit(*pairs[2]) for _ in range(8))
                time.sleep(0.3)
        th = threading.Thread(target=feeder)
        th.start()
        time.sleep(0.15)
        t0 = time.perf_counter()
        svc.submit(*pairs[5]).result(timeout=120)
        lone = time.perf_counter() - t0
        th.join()
        for f in flood:
            f.result(timeout=300)
        svc._launch = orig
        svc.max_hold_s = 0.1
        try:
            doomed.result(timeout=0)
            doomed_state = "resolved"
        except CancelledError:
            doomed_state = "cancelled"
        rec = {"phase": 12, "cancelled": cancelled,
               "cancelled_future": doomed_state, "busy_after": busy,
               "starved_bucket_latency_s": lone, "flood": len(flood)}
        emit(rec, log)
        check(cancelled and doomed_state == "cancelled" and busy == 0
              and lone < 2.0, f"cancel or starvation check failed: {rec}")

        # 4. throughput and latency at 1, 8 and 32 clients
        for clients in (1, 8, 32):
            svc.stats.reset()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()

            def closed_loop(c):
                for r in range(c, 128, clients):
                    svc.submit(*pairs[r % 4]).result(timeout=300)
            threads = [threading.Thread(target=closed_loop, args=(c,))
                       for c in range(clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t0
            counts = read_counts()
            snap = svc.stats.snapshot()
            emit({"phase": 12, "clients": clients, "requests": 128,
                  "bucket": list(hw), "pairs_per_s": 128 / wall,
                  "latency_ms_p50": snap["latency_ms_p50"],
                  "latency_ms_p99": snap["latency_ms_p99"],
                  "phase_ms_mean": snap["phase_ms_mean"],
                  "batch_hist": snap["batch_hist"],
                  "launches_per_request": {
                      k: counts[k] / 128 for k in
                      ("coarse_layer", "dual_softmax", "fine_stage")}},
                 log)
    finally:
        svc.close()

    # 5. the options, each held against itself with use_pallas=False
    options = {
        # GroupNorm's 8 groups do not divide the flagship's 196 channels:
        # the padded widths
        "group_norm": {"backbone": {"norm": "group",
                                    "block_dims": (128, 256, 256)}},
        # 16_4's coarse width is block_dims[3] and its fine width
        # block_dims[1]: at JAX's default (128, 196, 256, 512) no kernel
        # takes them (A and B need 256, C a multiple of 64), so the stages
        # get widths that run every kernel of the path
        "ResNetFPN_16_4": {"backbone": {"resolution": (16, 4),
                                        "block_dims": (128, 128, 196, 256)},
                           "fine": {"d_model": 128}},
        "full_attention": {"coarse": {"attention": "full"}},
        # and at JAX's default widths, on the plain path from the start:
        # kernels A and B take C = 256 only (coarse 512 here) and kernel C
        # a multiple of 64 (fine 196, 4 heads: 196 / 8 is no integer)
        "ResNetFPN_16_4_default_widths": {
            "backbone": {"resolution": (16, 4),
                         "block_dims": (128, 196, 256, 512)},
            "coarse": {"d_model": 512, "use_pallas": False},
            "match_coarse": {"use_pallas": False},
            "fine": {"d_model": 196, "nhead": 4, "use_pallas": False}}}
    plain_from_start = {
        "ResNetFPN_16_4_default_widths": "every stage (coarse 512: kernels "
        "A and B take 256; fine 196: kernel C takes multiples of 64)"}
    a, b = images_hw(6, *hw)
    inp = MatchInput(
        image0=torch.from_numpy(a[None, :, :, None] / np.float32(255)).to(dev),
        image1=torch.from_numpy(b[None, :, :, None] / np.float32(255)).to(dev))
    for name, over in options.items():
        cfg = get_config("indoor_ds", {"loftr": {**over, **thr0}})
        m = init_weights(LoFTR(cfg.loftr), 1)
        if name == "group_norm":
            with torch.no_grad():
                for mod in m.backbone.modules():
                    if isinstance(mod, torch.nn.GroupNorm):
                        mod.weight.copy_(torch.rand(
                            mod.num_channels, generator=g) + 0.5)
                        mod.bias.copy_(torch.randn(
                            mod.num_channels, generator=g) * 0.1)
        m = m.eval().to(dev)
        kern = with_config(m, {"dtype": "bfloat16"})
        plain = with_config(m, {"dtype": "bfloat16",
                                "coarse": {"use_pallas": False},
                                "match_coarse": {"use_pallas": False},
                                "fine": {"use_pallas": False}})
        plain32 = with_config(plain, {"dtype": "float32"})
        if name in plain_from_start:
            print(f"phase 12: option {name} runs on the plain path: "
                  f"{plain_from_start[name]}", flush=True)
            reset_counts()
            got = _stage_fields(plain, inp)
            torch.cuda.synchronize()
            counts = read_counts()
            want32 = _stage_fields(plain32, inp)
            n_valid = int(got[1].sum())
            rec = {"phase": 12, "option": name, "launches": counts,
                   "plain_path": plain_from_start[name],
                   "matches": [n_valid, int(want32[1].sum())],
                   "coarse_map_shape": list(got[0].shape),
                   "bf16_to_f32_coarse_map_err": float(
                       (got[0] - want32[0]).abs().mean()),
                   "finite": all(bool(torch.isfinite(t).all())
                                 for t in (got[0], got[4], got[5], got[6])),
                   "plain_model_ms": cuda_ms(lambda: plain(inp), iters=5)}
            emit(rec, log)
            # two backbone calls of two merges, every norm included
            expect_counts(counts, upsample_add=4)
            check(rec["finite"] and n_valid > 0
                  and rec["coarse_map_shape"] == [
                      1, (hw[0] // 16) * (hw[1] // 16), 512],
                  f"option {name} failed: {rec}")
            continue
        kern(inp)
        torch.cuda.synchronize()
        reset_counts()
        got = _stage_fields(kern, inp)
        torch.cuda.synchronize()
        counts = read_counts()
        ok, d = hold_model(got, _stage_fields(plain, inp),
                           _stage_fields(plain32, inp))
        want = dict(dual_softmax=1, fine_stage=1,
                    coarse_layer=0 if name == "full_attention" else 12,
                    upsample_add=4)
        rec = {"phase": 12, "option": name, "launches": counts,
               "plain_path": ("the coarse stack (attention 'full': kernel "
                              "A computes linear attention)"
                              if name == "full_attention" else None),
               "model_ms": cuda_ms(lambda: kern(inp), iters=5),
               "plain_model_ms": cuda_ms(lambda: plain(inp), iters=5),
               "ok": ok, **d}
        emit(rec, log)
        expect_counts(counts, **want)
        check(ok, f"option {name} disagrees with its plain path: {rec}")
    emit({"phase": 12, "wall_s": time.perf_counter() - t_phase}, log)
    return serve_counts


# --------------------------------------------------------------------------
# phase 13: the SfM backend and python -m loftr_tpu_torch.sfm
# --------------------------------------------------------------------------

# the report keys of the JAX package's sfm.py
SFM_KEYS = ("scene", "n_frames", "n_keyframes", "n_edges", "ba_cost")


def _rotations(w):
    """[N, 3] axis-angle (numpy) -> [N, 3, 3] float64 (the port's exp_so3)."""
    import torch
    from loftr_tpu_torch.sfm.lie import exp_so3
    return exp_so3(torch.from_numpy(w).double()).numpy()


class OracleScene:
    """``tests/test_sfm_pipeline.py``'s ``SynthScene`` (a camera translating
    0.12 m a frame through a point cloud, an oracle matcher with pixel
    noise, depth at the projected points) stretched over a long sweep: the
    points fill the whole path and the camera's yaw and roll wobble instead
    of growing, so every frame of ``n_frames`` sees the cloud."""

    def __init__(self, n_frames, n_pts, seed=0, noise=0.2):
        import numpy as np
        rng = np.random.RandomState(seed)
        self.K = np.array([[400.0, 0, 320], [0, 400.0, 240], [0, 0, 1]])
        self.pts = (rng.rand(n_pts, 3) * [8 + 0.12 * n_frames, 5, 4]
                    + [-4, -2.5, 4])
        self.noise = noise
        self.rng = rng
        f = np.arange(n_frames)
        self.R = _rotations(np.stack([0 * f, 0.1 * np.sin(f / 40.0),
                                      0.02 * np.sin(f / 25.0)], -1))
        centers = np.stack([0.12 * f, 0.02 * np.sin(f), 0.01 * f], -1)
        self.t = -np.einsum("nij,nj->ni", self.R, centers)
        self.n_frames = n_frames

    def project(self, f):
        Xc = self.pts @ self.R[f].T + self.t[f]
        uv = Xc @ self.K.T
        uv = uv[:, :2] / uv[:, 2:]
        vis = (Xc[:, 2] > 0.5) & (uv[:, 0] > 5) & (uv[:, 0] < 635) & \
              (uv[:, 1] > 5) & (uv[:, 1] < 475)
        return uv, vis, Xc[:, 2]

    def depth_map(self, f):
        import numpy as np
        uv, vis, z = self.project(f)
        depth = np.zeros((480, 640), np.float32)
        pix = np.round(uv[vis]).astype(int)
        depth[np.clip(pix[:, 1], 0, 479), np.clip(pix[:, 0], 0, 639)] = \
            z[vis]
        return depth

    def match_fn(self, a, b):
        import numpy as np
        uva, visa, _ = self.project(a)
        uvb, visb, _ = self.project(b)
        common = np.nonzero(visa & visb)[0]
        k0 = uva[common] + self.rng.randn(len(common), 2) * self.noise
        k1 = uvb[common] + self.rng.randn(len(common), 2) * self.noise
        return (k0.astype(np.float32), k1.astype(np.float32),
                common.astype(np.int64), common.astype(np.int64))


def long_ba_problem(C, P, O, noise, pose_noise, point_noise, seed=0,
                    window=30):
    """``tests/test_sfm_ba.py``'s BA generator scaled to a long scene:
    ``C`` keyframes 0.1 m apart along x with a small yaw wobble, ``P``
    points in front of the whole path, each seen by ``O`` distinct
    keyframes among the ``2 window + 1`` nearest (banded, as a sequence
    sees its map); normalized observations with ``noise``, poses and
    points perturbed as there, keyframe 0 fixed.  Vectorized numpy;
    returns (arrays of a BAProblem, R_gt, t_gt)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    span = 0.1 * (C - 1)
    pts = rng.rand(P, 3) * [span + 2, 3, 2] + [-1, -1.5, 6]
    c_idx = np.arange(C)
    R_gt = _rotations(np.stack([0 * c_idx, 0.05 * np.sin(c_idx / 7.0),
                                0 * c_idx], -1))
    centers = np.stack([0.1 * c_idx, 0.1 * rng.randn(C), 0 * c_idx], -1)
    t_gt = -np.einsum("nij,nj->ni", R_gt, centers)
    window = min(window, (C - 1) // 2)
    n_win = 2 * window + 1
    start = np.clip(np.round(pts[:, 0] / 0.1).astype(int) - window, 0,
                    C - n_win)
    obs_cam = (start[:, None]
               + np.argsort(rng.rand(P, n_win), 1)[:, :O]).astype(np.int64)
    Xc = (np.einsum("poij,pj->poi", R_gt[obs_cam], pts) + t_gt[obs_cam])
    obs_uv = (Xc[..., :2] / Xc[..., 2:]
              + rng.randn(P, O, 2) * noise).astype(np.float32)
    R0, t0 = R_gt.copy(), t_gt.copy()
    R0[1:] = _rotations(rng.randn(C - 1, 3) * pose_noise) @ R_gt[1:]
    t0[1:] += rng.randn(C - 1, 3) * pose_noise
    pts0 = pts + rng.randn(P, 3) * point_noise
    fix = np.zeros(C, bool)
    fix[0] = True
    arrays = dict(R=R0.astype(np.float32), t=t0.astype(np.float32),
                  points=pts0.astype(np.float32), obs_uv=obs_uv,
                  obs_cam=obs_cam, obs_w=np.ones((P, O), np.float32),
                  fix_mask=fix)
    return arrays, R_gt, t_gt


def _ba_problem(arrays, device, dtype=None):
    import torch
    from loftr_tpu_torch.sfm.bundle_adjustment import BAProblem
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(v).to(device)
        out[k] = t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return BAProblem(**out)


def _rel(a, b):
    """max |a - b| over max |b| (tensors on any device)."""
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _equal_bits(p, q):
    import torch
    return all(torch.equal(getattr(p, k), getattr(q, k))
               for k in ("R", "t", "points", "obs_w"))


def kernel_launches(fn, tries=3):
    """CUDA kernels (and memory copies / sets) one call of ``fn`` launches,
    from the profiler; None when a window records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if getattr(e, "device_type", None)
                 == torch.autograd.DeviceType.CUDA]
        if names:
            mem = sum(n.startswith(("Memcpy", "Memset")) for n in names)
            return {"kernels": len(names) - mem, "memcpy_memset": mem}
    return None


def sfm_cli_run(dev, log, n_frames, hw):
    """Phase 13, part 1: ``loftr_tpu_torch.sfm.cli.main`` in-process on a
    synthetic ScanNet-layout sequence with full-width ``indoor_ds`` bf16
    and seeded random weights, ``--keyframe-stride 5``; the launch counts
    of the run (the main path)."""
    import shutil
    import tempfile
    import torch
    from loftr_tpu_torch.data.synthetic import write_scannet_sequence
    from loftr_tpu_torch.sfm import cli
    from loftr_tpu_torch.utils.profiler import RegionProfiler

    root = tempfile.mkdtemp(prefix="loftr_sfm_")
    try:
        scene = os.path.join(root, "scene0000_00")
        t0 = time.perf_counter()
        write_scannet_sequence(scene, n_frames=n_frames, size=(hw[1], hw[0]),
                               seed=0)
        write_s = time.perf_counter() - t0
        prof = RegionProfiler()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        report = cli.main(
            ["--scene-dir", scene, "--intrinsic",
             os.path.join(scene, "intrinsic", "intrinsic_color.txt"),
             "--keyframe-stride", "5", "--resize", str(hw[1]), str(hw[0]),
             "--out", os.path.join(root, "traj.npz"), "--device", str(dev)],
            profiler=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        traj_ok = os.path.exists(os.path.join(root, "traj.npz"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    match_s = prof.times["sfm/match"]
    n_match = len(match_s)
    totals = prof.totals()
    host_s = sum(totals[k]["total_s"] for k in ("sfm/tracks", "sfm/problem"))
    rec = {"phase": 13, "part": "sfm_cli", "frames": n_frames,
           "hw": list(hw), "report": report, "launches": counts,
           "match_calls": n_match,
           "match_ms_mean": 1000 * sum(match_s) / n_match,
           "match_ms_after_first": (1000 * sum(match_s[1:]) / (n_match - 1)
                                    if n_match > 1 else None),
           "wall_s": wall, "write_sequence_s": write_s,
           "host_tracks_problem_s": host_s,
           # with no edge the tracks and the problem are empty: their share
           # of the run measures nothing of the backend
           "host_tracks_problem_share": (host_s / wall if report.get("n_edges")
                                         else None),
           "stages": totals, "peak_mem_MiB": peak,
           "note": ("seeded random weights: an untrained net finds few or "
                    "no matches (thr 0.2), so the sequence may give no "
                    "edges and no BA; no threshold was tuned")}
    emit(rec, log)
    check(set(SFM_KEYS) <= set(report) and "ate" in report and traj_ok,
          f"the SfM CLI's report lacks sfm.py's keys: {report}")
    check(n_match == 2 * (len(range(0, n_frames, 5)) - 1) - 1,
          f"{n_match} match calls for {n_frames} frames at stride 5")
    expect_counts(counts, coarse_layer=12 * n_match, dual_softmax=n_match,
                  fine_stage=n_match, upsample_add=2 * n_match)
    return counts


def sfm_oracle_run(dev, log, n_frames, n_pts):
    """Phase 13, part 2: ``run_sfm`` on the oracle scene with depth, dense
    and pcg, on the card and on the CPU (the same RANSAC draws): JAX's ATE
    bars; the card's camera centres within the tests' 1e-3 of the CPU's
    after a Sim(3) alignment, the alignment's scale within 1e-4 of 1; the
    card's stage times."""
    import numpy as np
    import torch
    from loftr_tpu_torch.sfm.ate import (absolute_trajectory_error,
                                         align_umeyama, camera_centers)
    from loftr_tpu_torch.sfm.pipeline import run_sfm
    from loftr_tpu_torch.utils.profiler import RegionProfiler

    cpu = torch.device("cpu")
    for solver in ("dense", "pcg"):
        outs = {}
        for device in (dev, cpu):
            scene = OracleScene(n_frames, n_pts, seed=0)
            depths = [scene.depth_map(f) if f % 5 == 0 else None
                      for f in range(n_frames)]
            prof = RegionProfiler()
            t0 = time.perf_counter()
            out = run_sfm(n_frames, scene.match_fn, scene.K, depths=depths,
                          keyframe_stride=5, link_range=2, ba_iters=15,
                          seed=0, ba_solver=solver, device=device,
                          profiler=prof)
            wall = time.perf_counter() - t0
            kfs = out["keyframes"]
            ate = absolute_trajectory_error(
                camera_centers(out["R"], out["t"]),
                camera_centers(scene.R[kfs], scene.t[kfs]))
            outs[device.type] = (out, ate, prof.totals(), wall)
        (o_d, ate_d, st_d, wall_d), (o_c, ate_c, _, wall_c) = (
            outs[dev.type], outs["cpu"])
        c_d = camera_centers(o_d["R"], o_d["t"])
        c_c = camera_centers(o_c["R"], o_c["t"])
        # the card's trajectory on the CPU's: BA leaves the map's scale a
        # gauge that float rounding moves along a 24 m path, so the shapes
        # are compared after a Sim(3) alignment, the scales apart
        s, R, t = align_umeyama(c_d, c_c)
        gap = float(np.abs(c_d - c_c).max())
        gap_aligned = float(np.abs(s * c_d @ R.T + t - c_c).max())
        ok = (len(o_d["edges"]) == len(o_c["edges"])
              and len(o_d["edges"]) >= len(o_d["keyframes"]) - 1
              and gap_aligned < 1e-3 and abs(s - 1) < 1e-4
              and all(abs(a["scale"] - 1) < 0.1 and a["ate_rmse"] < 0.05
                      for a in (ate_d, ate_c)))
        prob = o_d["problem"]
        rec = {"phase": 13, "part": "oracle", "solver": solver,
               "frames": n_frames, "points": n_pts,
               "keyframes": len(o_d["keyframes"]),
               "edges": len(o_d["edges"]),
               "ba_points": None if prob is None else prob.points.shape[0],
               "ate": ate_d, "ate_cpu": ate_c, "centre_gap_cpu": gap,
               "centre_gap_cpu_aligned": gap_aligned,
               "scale_to_cpu": s,
               "ba_cost": o_d["ba_cost"], "ba_cost_cpu": o_c["ba_cost"],
               "wall_s": wall_d, "wall_s_cpu": wall_c, "stages": st_d,
               "ok": ok}
        emit(rec, log)
        check(ok, f"the oracle trajectory fails its bars: {rec}")


def ba_scale_run(dev, log, C, P, O, noise=1e-3):
    """Phase 13, part 3: BA at keyframe scale (``long_ba_problem``): one
    ``ba_iteration`` dense and pcg on the card against the CPU, in float32
    and float64; full ``bundle_adjust`` to the noise floor, twice (equal
    bits); ms per LM iteration (events, profiled device ms), launches per
    iteration, peak memory; ``reset_point_outliers`` against the CPU on the
    adjusted map with planted outliers."""
    import numpy as np
    import torch
    from loftr_tpu_torch.sfm import bundle_adjustment as ba

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    arrays, _, _ = long_ba_problem(C, P, O, noise, pose_noise=0.01,
                                   point_noise=0.03, seed=0)
    gen_s = time.perf_counter() - t0
    p_dev = _ba_problem(arrays, dev)
    p_cpu = _ba_problem(arrays, cpu)
    p_64 = _ba_problem(arrays, cpu, torch.float64)
    M = int((p_cpu.obs_w > 0).sum()) * 2
    floor = M * noise ** 2
    lam = 1e-4
    for solver in ("dense", "pcg"):
        plan = ba.BAPlan(p_dev.obs_cam, C, pairs=solver == "dense")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        card = ba.ba_iteration(p_dev, lam, solver=solver, plan=plan)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        t0 = time.perf_counter()
        ref = ba.ba_iteration(p_cpu, lam, solver=solver)
        cpu_s = time.perf_counter() - t0
        f64 = ba.ba_iteration(p_64, lam, solver=solver)
        errs = {k: (_rel(getattr(card[0], k), getattr(f64[0], k)),
                    _rel(getattr(ref[0], k), getattr(f64[0], k)))
                for k in ("R", "t", "points")}
        cost_gap = [abs(float(a) - float(b)) / abs(float(b))
                    for a, b in zip(card[1:], ref[1:])]
        step_ok = (max(cost_gap) < 1e-5
                   and all(e[0] <= 2 * e[1] + 1e-6 for e in errs.values()))

        def step():
            return ba.ba_iteration(p_dev, lam, solver=solver, plan=plan)

        ms = cuda_ms(step, iters=5, warmup=1)
        dms = device_ms(step, iters=3)
        launches = kernel_launches(step)
        t0 = time.perf_counter()
        ba.BAPlan(p_dev.obs_cam, C, pairs=solver == "dense")
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(ba.bundle_adjust(p_dev, max_iters=25, solver=solver))
            runs[-1] += (time.perf_counter() - t0,)
        same = (_equal_bits(runs[0][0], runs[1][0])
                and runs[0][1] == runs[1][1])
        rec = {"phase": 13, "part": "ba_scale", "solver": solver,
               "C": C, "P": P, "O": O, "noise": noise,
               "generate_s": gen_s, "old_cost": float(card[1]),
               "new_cost": float(card[2]), "new_cost_cpu": float(ref[2]),
               "cost_gap_cpu": cost_gap,
               "err_to_float64_card_cpu": errs, "step_ok": step_ok,
               "ms_per_iteration": ms,
               "device_ms_per_iteration": None if dms is None
               else dms["total"],
               "device_top": None if dms is None else dict(sorted(
                   ((k, v) for k, v in dms.items() if k != "total"),
                   key=lambda kv: -kv[1])[:6]),
               "launches_per_iteration": launches,
               "plan_s": plan_s, "cpu_iteration_s": cpu_s,
               "peak_mem_MiB": peak,
               "final_cost": runs[0][1], "floor_3M_noise2": 3 * floor,
               "loop_s": [r[2] for r in runs], "bit_equal_runs": same}
        emit(rec, log)
        check(step_ok, f"BA step {solver} disagrees with the CPU: {rec}")
        check(same, f"two card runs of BA {solver} differ: {rec}")
        check(runs[0][1] < 3 * floor,
              f"BA {solver} misses the noise floor: {rec}")

        if solver == "dense":
            solved = runs[0][0]

    # the outlier reset on the adjusted map, with 2% of its points dragged
    # off by a gross outlier observation (run_sfm runs it after the Huber
    # rounds)
    rng = np.random.RandomState(1)
    bad = rng.choice(P, P // 50, replace=False)
    drag = {k: getattr(solved, k).cpu().numpy().copy() for k in arrays}
    drag["obs_uv"][bad, 0] += rng.randn(len(bad), 2).astype(np.float32) * 0.25
    drag["points"][bad] += rng.randn(len(bad), 3).astype(np.float32) * 0.5
    r_dev = _ba_problem(drag, dev)
    r_cpu = _ba_problem(drag, cpu)
    thr = 0.005
    planted = torch.zeros(P, O, dtype=torch.bool)
    planted[torch.from_numpy(bad), 0] = True
    # good observations beyond the gate by noise alone: a 2-d Gaussian
    # residual of std ``noise`` exceeds thr with probability
    # exp(-thr^2 / (2 noise^2)) (about 3 of the 800,000 at 5 noise)
    n_good = int((~planted & (r_cpu.obs_w > 0)).sum())
    good_expected = n_good * math.exp(-thr ** 2 / (2 * noise ** 2))
    out = {}
    for gn in (0, 8):
        got = ba.reset_point_outliers(r_dev, thr, gn_iters=gn)
        want = ba.reset_point_outliers(r_cpu, thr, gn_iters=gn)
        zero = want.obs_w == 0
        out[gn] = {
            "gates_differ": int((got.obs_w.cpu() != want.obs_w).sum()),
            "points_max_abs": float((got.points.cpu()
                                     - want.points).abs().max()),
            "planted_zeroed": int((zero & planted).sum()),
            "good_zeroed": int((zero & ~planted).sum())}
        if gn == 0:
            # before the polish a point moves only where it switched to a
            # two-view candidate; a candidate from keyframes 0.1 m apart at
            # 7 m is ill conditioned, so its float32 value is reported, not
            # held (the polish below is)
            out[gn]["switches_differ"] = int(
                ((got.points.cpu() != r_cpu.points).any(1)
                 != (want.points != r_cpu.points).any(1)).sum())
    ms = cuda_ms(lambda: ba.reset_point_outliers(r_dev, thr), iters=3,
                 warmup=1)
    again = ba.reset_point_outliers(r_dev, thr)
    same = _equal_bits(again, ba.reset_point_outliers(r_dev, thr))
    # after the polish: at least 95% of the planted outliers zeroed, and of
    # the good observations no more than the noise's tail puts beyond the
    # gate (bar: 10 against an expected ~3)
    ok = (all(v["gates_differ"] == 0 for v in out.values())
          and out[0]["switches_differ"] == 0
          and out[8]["points_max_abs"] < 1e-4 and same
          and out[8]["planted_zeroed"] >= 0.95 * len(bad)
          and out[8]["good_zeroed"] <= max(10, 3 * good_expected))
    rec = {"phase": 13, "part": "reset_outliers", "P": P,
           "dragged": len(bad), "good_observations": n_good,
           "good_beyond_gate_expected": good_expected, "by_gn_iters": out,
           "ms": ms, "bit_equal_runs": same, "ok": ok}
    emit(rec, log)
    check(ok, f"reset_point_outliers disagrees with the CPU: {rec}")


def sfm_path(dev, log, n_frames=60, hw=(H, W), oracle=(200, 2000),
             big=(300, 100_000, 8)):
    """Phase 13: the SfM CLI end to end (part 1, the main path: its launch
    counts are returned), the backend on the oracle scene card against CPU
    (part 2), BA at keyframe scale (part 3)."""
    t_phase = time.perf_counter()
    counts = sfm_cli_run(dev, log, n_frames, hw)
    sfm_oracle_run(dev, log, *oracle)
    ba_scale_run(dev, log, *big)
    emit({"phase": 13, "wall_s": time.perf_counter() - t_phase}, log)
    return counts


# --------------------------------------------------------------------------
# phase 14: the parallel modules
# --------------------------------------------------------------------------

# a phase-14 rank must finish within this many seconds of its start
RANK_TIMEOUT = 300


def spawn_ranks(item, world, work, env=None, timeout=RANK_TIMEOUT):
    """Run ``world`` ranks of ``item`` (``chip_smoke.py --rank``), each a
    process with torchrun's variables and a ``file://`` store under
    ``work``; wait for all of them.  A rank that fails or runs past
    ``timeout`` fails the phase (every rank is killed first).  Returns the
    ranks' records and the wall seconds."""
    import torch
    store = os.path.join(work, f"store_{item}")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", item, work],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_RANK="0", LOFTR_INIT_METHOD="file://" + store,
                 **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO) for r in range(world)]
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        outs = []
        for p in procs:
            p.kill()
            outs.append(p.communicate()[0])
        check(False, f"phase 14 {item}: ranks ran past {timeout} s:\n"
              + "\n".join(o[-4000:] for o in outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0,
              f"phase 14 {item}: rank {r} exited {p.returncode}:\n"
              f"{out[-8000:]}")
    return ([torch.load(os.path.join(work, f"{item}_{r}.pt"),
                        weights_only=False) for r in range(world)],
            time.perf_counter() - t0)


def rank_main(item, work):
    """One rank of phase 14 (``chip_smoke.py --rank ITEM WORK``): joins the
    process group from the environment (``parallel.mesh.
    init_process_group``: gloo for the two-rank items, NCCL for ``nccl``),
    runs ``ITEM`` and saves its record under ``WORK``."""
    import torch
    sys.path.insert(0, REPO)
    from loftr_tpu_torch.parallel.mesh import init_process_group
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = spec["nccl_backend"] if item == "nccl" else "gloo"
    rank, world = init_process_group(dev, backend=backend)
    try:
        rec = {"gloo": rank_gloo, "nccl": rank_nccl}[item](dev, spec, rank)
        torch.save(rec, os.path.join(work, f"{item}_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _cpu(sd):
    """A copy on the host (``.cpu()`` alone aliases a CPU tensor)."""
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def rank_gloo(dev, spec, rank):
    """A rank of the two-rank gloo group: the data-parallel train step, the
    sharded BA iteration, the token-sharded coarse stack and the evaluator
    merge, each timed."""
    import torch
    from loftr_tpu_torch.models.matcher import LoFTR
    from loftr_tpu_torch.models.transformer import LocalFeatureTransformer
    from loftr_tpu_torch.parallel import comm
    from loftr_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from loftr_tpu_torch.parallel.seq_attention import sharded_coarse_stack
    from loftr_tpu_torch.sfm import bundle_adjustment as ba
    from loftr_tpu_torch.train.trainer import Trainer
    from loftr_tpu_torch.utils.weights import init_weights
    mesh = make_mesh()
    group = mesh.group("data")
    rec = {}

    # 1. the data-parallel train step in float32 (the exact check) and
    # bf16 (the main path, timed), the gradients recorded; rank 1 starts
    # from other weights, replicate gives it rank 0's
    tr = spec["train"]
    batch = shard_batch(mesh, tr["batch"])
    noise = {k: v.to(dev) for k, v in tr["noise"].items()}
    rec["train"] = {}
    for dt, cfg in tr["cfg"].items():
        trainer = Trainer(cfg, world_size=2, batch_size_per_device=1,
                          device=dev)
        other = None
        if rank:
            m = LoFTR(cfg.loftr)
            init_weights(m, 1)
            other = m.state_dict()
        state = trainer.init_state(seed=0, state_dict=other)
        start = all(torch.equal(v.cpu(), tr["init"][k])
                    for k, v in state.module.state_dict().items())
        grads = recording_grads(trainer, state)
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        state, sc = trainer.train_step(state, batch, noise)
        _sync(dev)
        r = rec["train"][dt] = {
            "start_is_rank0": start, "counts": read_counts(),
            "scalars": {k: float(v) for k, v in sc.items()},
            "after": _cpu(state.module.state_dict()), "grads": grads,
            "first_step_s": time.perf_counter() - t0}
        if dt == "bfloat16":
            ms = []
            for _ in range(tr["timed_steps"]):
                _sync(dev)
                t0 = time.perf_counter()
                trainer.train_step(state, batch)
                _sync(dev)
                ms.append(1e3 * (time.perf_counter() - t0))
            r["step_ms"] = ms
        del state, trainer

    # 2. one sharded LM iteration, dense and pcg
    bs = spec["ba"]
    prob = ba.shard_problem(_ba_problem(bs["arrays"], dev), mesh)
    rec["ba"] = {}
    for solver in ("dense", "pcg"):
        step = ba.make_sharded_ba_iteration(mesh, "data", solver)
        plan = ba.BAPlan(prob.obs_cam, prob.n_cams, pairs=solver == "dense")
        new, old_c, new_c = step(prob, bs["lam"], plan)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(bs["timed"]):
            step(prob, bs["lam"], plan)
        _sync(dev)
        rec["ba"][solver] = {
            "R": new.R.cpu(), "t": new.t.cpu(), "points": new.points.cpu(),
            "old": float(old_c), "new": float(new_c),
            "ms": 1e3 * (time.perf_counter() - t0) / bs["timed"]}
    del prob

    # 3. the coarse stack with its tokens sharded, linear and full
    sq = spec["seq"]
    rec["seq"] = {}
    for kind in ("linear", "full"):
        stack = LocalFeatureTransformer(sq["d"], sq["h"], sq["names"], kind)
        stack.load_state_dict(sq["state_" + kind])
        stack = stack.to(dev).eval()
        f0, f1 = (sq[n].to(dev) for n in ("f0", "f1"))
        staged0 = dict(comm.STAGED)
        with torch.no_grad():
            c0, c1 = sharded_coarse_stack(stack, f0, f1, None, None,
                                          "concat", group)
            staged = {k: comm.STAGED[k] - staged0[k] for k in staged0}
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(sq["timed"]):
                sharded_coarse_stack(stack, f0, f1, None, None, "concat",
                                     group)
            _sync(dev)
        rec["seq"][kind] = {"c0": c0.cpu(), "c1": c1.cpu(),
                            "staged": staged,
                            "ms": 1e3 * (time.perf_counter() - t0)
                            / sq["timed"]}

    # 4. the evaluator over this rank's pairs, merged across the ranks
    ev = spec["eval"]
    t0 = time.perf_counter()
    rec["eval"] = {"metrics": _evaluator(ev, dev).evaluate_dataset(
        _eval_dataset(ev), batch_size=1, num_workers=0, world_size=2,
        rank=rank), "s": time.perf_counter() - t0}
    return rec


def recording_grads(trainer, state):
    """A dict that the trainer's next step fills with the gradients it
    applies (after the sum over the ranks), by name, on the host."""
    out = {}
    names = [n for n, _ in state.module.named_parameters()]
    apply = trainer.apply_gradients

    def recording(st, grads):
        out.update({n: g.detach().cpu().clone()
                    for n, g in zip(names, grads)})
        return apply(st, grads)

    trainer.apply_gradients = recording
    return out


def rank_nccl(dev, spec, rank):
    """The one-rank NCCL group: the data-parallel step (``Trainer(group=)``)
    against the step without a group, from the same weights, batch and
    noise, under deterministic algorithms (cuDNN's, a fixed cuBLAS
    workspace), so that two runs of one step give equal bits."""
    import torch
    from loftr_tpu_torch.train.trainer import Trainer
    tr = spec["train"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    for name, group in (("plain", None),
                        ("group", torch.distributed.group.WORLD)):
        trainer = Trainer(tr["cfg"]["bfloat16"], batch_size_per_device=2,
                          device=dev, group=group)
        state = trainer.init_state(seed=0)
        noise = {k: v.to(dev) for k, v in tr["noise"].items()}
        reset_counts()
        state, sc = trainer.train_step(state, tr["batch"], noise)
        _sync(dev)
        out[name] = {"scalars": {k: float(v) for k, v in sc.items()},
                     "after": _cpu(state.module.state_dict()),
                     "counts": read_counts()}
        del state, trainer
    out["backend"] = torch.distributed.get_backend()
    return out


def _eval_dataset(ev):
    from loftr_tpu_torch.data.megadepth import MegaDepthDataset
    from loftr_tpu_torch.data.sampler import ConcatDataset
    return ConcatDataset([MegaDepthDataset(
        ev["root"], n, mode="test", img_resize=ev["size"], df=8,
        img_padding=True) for n in ev["npz"]])


def _evaluator(ev, dev):
    from loftr_tpu_torch.eval.evaluator import Evaluator
    from loftr_tpu_torch.models.matcher import LoFTR
    model = LoFTR(ev["cfg"].loftr)
    model.load_state_dict(ev["state"])
    return Evaluator(ev["cfg"], model.to(dev), pose_solver="native",
                     device=dev)


def _moved_apart(after, want, before, lr):
    """Two states after one step from the state ``before`` (``want`` the
    reference): the parameters' largest difference and the share of their
    elements beyond half a learning rate (Adam's first step moves an
    element by lr * sign(g), so an element whose gradient is rounding noise
    may differ by 2 lr; all others agree far below one lr), and the running
    statistics' largest difference with the key that holds it.  Those are
    this step's batch statistics, recovered from the running ones; the
    variance is E[x^2] - E[x]^2 in float32, so what the two sums carry is
    the second moment: errors are taken against it (the mean's against its
    square root)."""
    worst, far, n, stat, stat_key = 0.0, 0, 0, 0.0, None
    for k, a in after.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (a.double() - want[k].double()).abs()
        if k.endswith(("running_mean", "running_var")):
            base = k.rsplit(".", 1)[0]
            mom = 0.1
            bm, bv = ((want[base + "." + s_].double() - (1 - mom)
                       * before[base + "." + s_].double()) / mom
                      for s_ in ("running_mean", "running_var"))
            m2 = bv + bm * bm
            scale = m2 if k.endswith("running_var") else m2.sqrt()
            e = float((d / mom / scale.clamp_min(1e-12)).max())
            if e > stat:
                stat, stat_key = e, k
            continue
        worst = max(worst, float(d.max()))
        far += int((d > 0.5 * lr).sum())
        n += d.numel()
    return worst, far / max(n, 1), stat, stat_key


def mesh_service_run(dev, log, smi, hw=(H, W), n_requests=16):
    """Phase 14, the service across devices: ``MatchingService(mesh=...)``
    with a one-device mesh (the card's one replica; rungs 1, 2, 4;
    interleave packing) on ``indoor_ds`` bf16 seeded weights, thr 0, uint8
    wire.  One request equal to ``match_pair`` exactly; ``n_requests``
    from 4 clients, each held to ``match_pair`` of its pair as phase 12
    holds them (the near-tie rule, mconf within the bf16 floor); kernels
    A-C launched.  Returns the launch counts of the requests."""
    import threading
    import numpy as np
    import torch
    from loftr_tpu_torch.api import load_matcher, match_pair, with_config
    from loftr_tpu_torch.parallel.mesh import local_device_mesh
    from loftr_tpu_torch.serve import MatchingService

    thr0 = {"match_coarse": {"thr": 0.0}}
    base = load_matcher(seed=0, device=dev)
    sd = {k: v.detach().cpu() for k, v in base.state_dict().items()}
    fast = with_config(base, {"dtype": "bfloat16", **thr0})
    plain = with_config(fast, {"match_coarse": {"use_pallas": False}})
    svc = MatchingService(sd, overrides={"loftr": thr0}, buckets=(hw,),
                          batch_sizes=(1, 2, 4), flush_ms=5.0,
                          wire_dtype="uint8", mesh=local_device_mesh([dev]))
    try:
        check(svc.config.loftr.batch_packing == "interleave"
              and svc.devices == [dev], "the meshed service's setup")
        svc.warmup()
        pairs = [images_hw(40 + k, *hw) for k in range(4)]
        oracle = [(match_pair(p0, p1, fast),
                   match_pair(p0, p1, fast, dtype="float32"))
                  for p0, p1 in pairs]
        one = svc.match(*pairs[0])
        exact = all(np.array_equal(one[k], oracle[0][0][k]) for k in one)
        results = [None] * n_requests
        svc.stats.reset()
        _sync(dev)
        reset_counts()
        t0 = time.perf_counter()

        def client(c):
            for r in range(c, n_requests, 4):
                results[r] = svc.submit(*pairs[r % 4]).result(timeout=300)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = read_counts()
        snap = svc.stats.snapshot()
    finally:
        svc.close()
    odd, errs, floor = 0, [], []
    for k, (p0, p1) in enumerate(pairs):
        from loftr_tpu_torch.structs import MatchInput
        inp = MatchInput(
            image0=torch.from_numpy(p0[None, :, :, None]
                                    / np.float32(255)).to(dev),
            image1=torch.from_numpy(p1[None, :, :, None]
                                    / np.float32(255)).to(dev))
        with torch.no_grad():
            conf = plain(inp).conf_matrix[0].float()
        h = hold_responses(results[k::4], *oracle[k], conf, p0.shape[1] // 8)
        odd += len(h[0])
        errs += h[1]
        floor += h[2]
    ok = (exact and one["mconf"].shape[0] > 0 and odd == 0 and errs
          and float(np.mean(errs)) <= float(np.mean(floor))
          and min(counts[k] for k in ("coarse_layer", "dual_softmax",
                                      "fine_stage")) > 0)
    rec = {"phase": 14, "part": "mesh_service", "nvidia_smi": smi,
           "devices": [str(d) for d in svc.devices],
           "batch_sizes": list(svc.batch_sizes),
           "one_request_exact": exact, "requests": n_requests,
           "odd_matches": odd, "matches_both": len(errs),
           "mconf_err": float(np.mean(errs)) if errs else None,
           "mconf_floor": float(np.mean(floor)) if floor else None,
           "batch_hist": snap["batch_hist"], "pairs_per_s":
           n_requests / wall, "latency_ms_p50": snap["latency_ms_p50"],
           "launches": counts, "ok": bool(ok)}
    emit(rec, log)
    check(ok, f"the meshed service's responses disagree: {rec}")
    return counts


def parallel_path(dev, log, smi, hw=(H, W), train_overrides=None,
                  ba_size=(300, 100_000, 8), seq_len=4800, eval_size=256,
                  eval_overrides=None, nccl_backend="nccl"):
    """Phase 14: the parallel modules on one card.  The single-process
    references first (the B=2 train step, ``ba_iteration`` dense and pcg
    and its float64 twin, the unsharded coarse stack, ``evaluate_dataset``
    in one process), then two gloo ranks on the card (train step, sharded
    BA, token-sharded stack, evaluator merge), then one NCCL rank (its
    data-parallel step against the plain one, bit for bit).  Returns the
    kernel launch counts of rank 0's train step."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from loftr_tpu_torch.config import get_config
    from loftr_tpu_torch.data.synthetic import make_synthetic_megadepth
    from loftr_tpu_torch.models.transformer import LocalFeatureTransformer
    from loftr_tpu_torch.ops.matching import draw_select_noise
    from loftr_tpu_torch.sfm import bundle_adjustment as ba
    from loftr_tpu_torch.train.trainer import Trainer
    from loftr_tpu_torch.utils.weights import init_weights

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="loftr_phase14_")
    try:
        # --- the train step: B = 2 in one process, bf16 and float32
        cfgs = {dt: train_config(dt, 2) for dt in ("float32", "bfloat16")}
        if train_overrides:
            cfgs = {k: v.replaced(train_overrides) for k, v in cfgs.items()}
        batch = train_batch(7, 2, hw)
        L = (hw[0] // 8) * (hw[1] // 8)
        mc = cfgs["bfloat16"].loftr.match_coarse
        k_train = mc.train_matches or int(mc.train_coarse_percent * L)
        noise = draw_select_noise(2, L, k_train, mc.train_sampling,
                                  torch.Generator().manual_seed(7), "cpu")
        one = {}
        for dt, cfg in cfgs.items():
            trainer = Trainer(cfg, batch_size_per_device=2, device=dev)
            state = trainer.init_state(seed=0)
            init = _cpu(state.module.state_dict())
            grads = recording_grads(trainer, state)
            reset_counts()
            state, sc = trainer.train_step(
                state, batch, {k: v.to(dev) for k, v in noise.items()})
            _sync(dev)
            one[dt] = {"scalars": {k: float(v) for k, v in sc.items()},
                       "after": _cpu(state.module.state_dict()),
                       "grads": grads, "counts": read_counts()}
            del state, trainer

        # --- BA at keyframe scale: one iteration, float32 and float64
        C, P, O = ba_size
        arrays, _, _ = long_ba_problem(C, P, O, 1e-3, pose_noise=0.01,
                                       point_noise=0.03, seed=0)
        lam = 1e-4
        p32 = _ba_problem(arrays, dev)
        p64 = _ba_problem(arrays, dev, torch.float64)
        ba_one = {}
        for solver in ("dense", "pcg"):
            plan = ba.BAPlan(p32.obs_cam, C, pairs=solver == "dense")
            r32 = ba.ba_iteration(p32, lam, solver=solver, plan=plan)
            r64 = ba.ba_iteration(p64, lam, solver=solver, plan=plan)
            ms = cuda_ms(lambda: ba.ba_iteration(
                p32, lam, solver=solver, plan=plan), iters=3, warmup=0) \
                if dev.type == "cuda" else None
            ba_one[solver] = {"f32": r32, "f64": r64, "ms": ms}
        del p32, p64

        # --- the coarse stack, unsharded (float32, TF32 off)
        g = torch.Generator().manual_seed(5)
        c = cfg.loftr.coarse
        f0 = torch.randn((1, seq_len, c.d_model), generator=g)
        f1 = torch.randn((1, seq_len, c.d_model), generator=g)
        seq = {"d": c.d_model, "h": c.nhead, "names": c.layer_names,
               "f0": f0, "f1": f1, "timed": 3}
        seq_one = {}
        for kind in ("linear", "full"):
            torch.manual_seed(11)
            stack = LocalFeatureTransformer(c.d_model, c.nhead,
                                            c.layer_names, kind)
            seq["state_" + kind] = _cpu(stack.state_dict())
            stack = stack.to(dev).eval()
            d0, d1 = f0.to(dev), f1.to(dev)
            with torch.no_grad():
                r = stack(d0, d1)
                ms = cuda_ms(lambda: stack(d0, d1), iters=3, warmup=0) \
                    if dev.type == "cuda" else None
            seq_one[kind] = {"c0": r[0].cpu(), "c1": r[1].cpu(), "ms": ms}
            del stack, r, d0, d1

        # --- the evaluator in one process
        root = os.path.join(work, "synth")
        npz = make_synthetic_megadepth(root, n_scenes=2, n_views=3,
                                       img_size=eval_size, seed=4,
                                       depth_format="npy")
        ecfg = get_config("outdoor_ds", eval_overrides or {"loftr": {
            "dtype": "bfloat16", "match_coarse": {"thr": 0.0}}})
        from loftr_tpu_torch.models.matcher import LoFTR
        em = LoFTR(ecfg.loftr)
        init_weights(em, 3)
        ev = {"cfg": ecfg, "state": em.state_dict(), "root": root,
              "npz": sorted(npz), "size": eval_size}
        t0 = time.perf_counter()
        eval_one = _evaluator(ev, dev).evaluate_dataset(
            _eval_dataset(ev), batch_size=1, num_workers=0)
        eval_one_s = time.perf_counter() - t0
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        torch.save({"device": str(dev), "nccl_backend": nccl_backend,
                    "train": {"cfg": cfgs, "init": init, "batch": batch,
                              "noise": noise, "timed_steps": 3},
                    "ba": {"arrays": arrays, "lam": lam, "timed": 3},
                    "seq": seq, "eval": ev}, os.path.join(work, "spec.pt"))

        # --- two gloo ranks on the card
        recs, gloo_s = spawn_ranks("gloo", 2, work)
        for dt in cfgs:
            a, b = (r["train"][dt] for r in recs)
            want = one[dt]
            lr = want["scalars"]["lr"]
            rel = {k: abs(a["scalars"][k] - want["scalars"][k])
                   / max(abs(want["scalars"][k]), 1e-30)
                   for k in ("loss", "loss_c", "loss_f", "grad_norm")}
            worst, far, stat, _ = _moved_apart(a["after"], want["after"],
                                               init, lr)
            ranks_equal = (a["scalars"] == b["scalars"] and all(
                torch.equal(v, b["after"][k])
                for k, v in a["after"].items()))
            for r in (a, b):
                expect_counts(r["counts"], dual_softmax=1,
                              focal_loss_forward=1, focal_loss_backward=1)
            # the summed gradients against one process's, by tensor (of
            # its largest entry), and the largest difference after Adam's
            # first update where the gradient's sign looks determined
            # (above 1e-3 of the largest): reported.  A ReLU input within
            # rounding of 0 takes the other side when cuDNN runs another
            # algorithm (batch 2 packed against 4), which moves gradients
            # near it by their own size (phase 5 meets the same between
            # card and CPU)
            g_err, sure_err, g_worst = 0.0, 0.0, None
            for k, w in want["grads"].items():
                e = float((a["grads"][k] - w).abs().max()
                          / w.abs().max().clamp_min(1e-30))
                if e > g_err:
                    g_err, g_worst = e, (k, float(w.abs().max()))
                sure = w.abs() > 1e-3 * w.abs().max()
                d = (a["after"][k] - want["after"][k]).abs()[sure]
                if d.numel():
                    sure_err = max(sure_err, float(d.max()))
            if dt == "float32":
                # TF32 off: phase 5's float32 bars (card against CPU)
                ok = (max(rel["loss"], rel["loss_c"], rel["loss_f"]) <= 1e-3
                      and rel["grad_norm"] <= 2e-2 and worst <= 2.2 * lr
                      and far <= 0.05 and stat <= 1e-3)
            else:
                # bf16 rounds every product, and the ranks' convolutions
                # run at another batch size than one process's: a sum of
                # many cancelling bf16 terms (BatchNorm's bias gradients)
                # carries noise beyond its own size, and an element whose
                # gradient is noise moves +-lr either way under Adam: the
                # share beyond half a rate is reported, held in float32
                ok = (max(rel["loss"], rel["loss_c"], rel["loss_f"]) <= 1e-2
                      and rel["grad_norm"] <= 5e-2 and worst <= 2.2 * lr
                      and stat <= 1e-2)
            ok = (ok and a["start_is_rank0"] and b["start_is_rank0"]
                  and ranks_equal)
            rec = {"phase": 14, "part": "dp_train_step", "nvidia_smi": smi,
                   "backend": "gloo", "ranks": 2, "global_batch": 2,
                   "hw": list(hw), "dtype": dt,
                   "rel_err_vs_one_process": rel,
                   "grad_max_err_of_tensor_max": g_err,
                   "grad_worst_tensor_and_max": g_worst,
                   "param_max_diff_sign_determined": sure_err,
                   "param_max_abs_diff": worst, "lr": lr,
                   "param_frac_beyond_half_lr": far,
                   "running_stat_max_rel_err": stat,
                   "ranks_bit_equal": ranks_equal,
                   "launches_rank0": a["counts"],
                   "launches_rank1": b["counts"],
                   "launches_one_process": want["counts"],
                   "first_step_s": [a["first_step_s"], b["first_step_s"]],
                   "ok": ok}
            if dt == "bfloat16":
                rec.update(step_ms_rank0=a["step_ms"],
                           step_ms_rank1=b["step_ms"],
                           note="two ranks share one card: their steps "
                                "overlap")
            emit(rec, log)
            check(ok, f"the data-parallel step disagrees: {rec}")
        dp_counts = recs[0]["train"]["bfloat16"]["counts"]

        for solver in ("dense", "pcg"):
            ra, rb = (r["ba"][solver] for r in recs)
            r32, r64 = ba_one[solver]["f32"], ba_one[solver]["f64"]
            cams_equal = (torch.equal(ra["R"], rb["R"])
                          and torch.equal(ra["t"], rb["t"])
                          and ra["old"] == rb["old"]
                          and ra["new"] == rb["new"])
            pts = torch.cat([ra["points"], rb["points"]])
            errs = {"R": (_rel(ra["R"], r64[0].R), _rel(r32[0].R, r64[0].R)),
                    "t": (_rel(ra["t"], r64[0].t), _rel(r32[0].t, r64[0].t)),
                    "points": (_rel(pts, r64[0].points),
                               _rel(r32[0].points, r64[0].points))}
            gap = [abs(ra["old"] - float(r32[1])) / abs(float(r32[1])),
                   abs(ra["new"] - float(r32[2])) / abs(float(r32[2]))]
            # the costs as phase 13 holds card and CPU; the state no
            # further from float64 than twice the single process's step
            ok = (cams_equal and max(gap) < 1e-5
                  and all(e[0] <= 2 * e[1] + 1e-6 for e in errs.values()))
            rec = {"phase": 14, "part": "sharded_ba", "nvidia_smi": smi,
                   "solver": solver, "C": C, "P": P, "O": O, "ranks": 2,
                   "cost_gap_vs_one_process": gap,
                   "err_to_float64_sharded_one": errs,
                   "cameras_bit_equal_across_ranks": cams_equal,
                   "ms_per_iteration_ranks": [ra["ms"], rb["ms"]],
                   "ms_per_iteration_one_process": ba_one[solver]["ms"],
                   "ok": ok}
            emit(rec, log)
            check(ok, f"the sharded BA disagrees: {rec}")

        for kind in ("linear", "full"):
            want = seq_one[kind]
            errs = []
            for r in recs:
                got = r["seq"][kind]
                for k in ("c0", "c1"):
                    errs.append(float((got[k] - want[k]).abs().max()
                                      / want[k].abs().max()))
            staged = [r["seq"][kind]["staged"] for r in recs]
            # float32: the ranks' key sums (linear) or online softmax
            # (full) in another order, through 8 layers
            ok = max(errs) <= 1e-4
            rec = {"phase": 14, "part": "seq_sharded_stack",
                   "nvidia_smi": smi, "attention": kind, "L": seq_len,
                   "S": seq_len, "d_model": seq["d"], "layers":
                   len(seq["names"]), "dtype": "float32", "ranks": 2,
                   "max_rel_err_vs_unsharded": max(errs),
                   "staged_through_host": staged,
                   "ms_ranks": [r["seq"][kind]["ms"] for r in recs],
                   "ms_unsharded": want["ms"], "ok": ok}
            emit(rec, log)
            check(ok, f"the token-sharded stack disagrees: {rec}")
            # gloo carries all-gather and point-to-point for CPU tensors
            # only: on the card both go through host memory
            check(dev.type != "cuda" or all(
                s["all_gather"] > 0 and (kind == "linear"
                                         or s["ring_shift"] > 0)
                for s in staged), f"the card's exchanges were not staged: "
                f"{staged}")

        got = [r["eval"]["metrics"] for r in recs]
        ok = all(set(m) == set(eval_one) and all(
            math.isclose(m[k], eval_one[k], rel_tol=1e-12, abs_tol=1e-15)
            for k in eval_one) for m in got)
        rec = {"phase": 14, "part": "evaluator_merge", "nvidia_smi": smi,
               "pairs": len(_eval_dataset(ev)), "ranks": 2,
               "metrics_one_process": eval_one, "metrics_ranks": got,
               "s_ranks": [r["eval"]["s"] for r in recs],
               "s_one_process": eval_one_s, "ok": ok}
        emit(rec, log)
        check(ok, f"the evaluator merge differs from one process: {rec}")

        # --- one NCCL rank: the data-parallel step equals the plain one
        (n,), nccl_s = spawn_ranks("nccl", 1, work, env={
            "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
        same = (n["plain"]["scalars"] == n["group"]["scalars"] and all(
            torch.equal(v, n["group"]["after"][k])
            for k, v in n["plain"]["after"].items()))
        expect_counts(n["group"]["counts"], dual_softmax=1,
                      focal_loss_forward=1, focal_loss_backward=1)
        rec = {"phase": 14, "part": "nccl_one_rank", "nvidia_smi": smi,
               "backend": n["backend"], "bit_equal_to_plain_step": same,
               "scalars": n["group"]["scalars"],
               "launches": n["group"]["counts"], "wall_s": nccl_s,
               "ok": same}
        emit(rec, log)
        check(same, f"the one-rank {n['backend']} step differs: {rec}")
        if dev.type == "cuda":
            with torch.no_grad():
                mesh_service_run(dev, log, smi, hw)
        emit({"phase": 14, "gloo_ranks_wall_s": gloo_s,
              "wall_s": time.perf_counter() - t_phase}, log)
        return dp_counts
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank"]:                 # a rank of phase 14
        return rank_main(*argv[1:3])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14")
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
                               ("upsample.cu", "upsample2x_band"),
                               ("upsample.cu", "upsample2x_add_nhwc")):
            check(ptxas is None or not any(
                k.startswith(src_name + ":") and kern in k
                for k in ptxas["spilling_kernels"]),
                f"a bf16 pass of {src_name} spills: {ptxas}")
        results = {}
        main_counts = train_counts = ot_counts = cli_counts = None
        serve_counts = sfm_counts = dp_counts = None
        with torch.no_grad():  # the inference phases carry no graph
            if 2 in phases:
                kernel_checks(dev, log, results)
                new_kernel_checks(dev, log, results)
                window_upsample_checks(dev, log, results)
                merge_checks(dev, log, results)
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
                _, wa_counts = ot_switches(dev, log, ot_matcher)
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
        if 12 in phases:
            with torch.no_grad():
                serve_counts = serve_path(dev, log)
        if 13 in phases:
            sfm_counts = sfm_path(dev, log)
        if 14 in phases:
            dp_counts = parallel_path(dev, log, smi)
        if results and None not in (main_counts, train_counts, ot_counts):
            pal = "loftr_tpu/ops/pallas/"
            src = {"coarse_layer": ("coarse_layer.cu", "coarse_layer.py:117"),
                   "dual_softmax": ("dual_softmax.cu", "dual_softmax.py:132"),
                   "fine_stage": ("fine_stage.cu", "fine_stage.py:263"),
                   "focal_loss": ("focal_loss.cu", "focal_loss.py:230"),
                   "sinkhorn": ("sinkhorn.cu", "sinkhorn.py:162"),
                   "window_attention": ("window_attention.cu",
                                        "window_attention.py:98"),
                   "upsample": ("upsample.cu", "upsample.py:48"),
                   "upsample_add": ("upsample.cu", "upsample.py:48")}
            # launches: kernels A, B, C in one match_pair call of
            # indoor_ds; kernel D (forward + backward) in the 8 training
            # steps, where kernel B also runs once a step; kernel E in one
            # match_pair call of indoor_ot (with A x12 and C again);
            # kernel F in phase 8's fine layer stack; kernel G's FPN merge
            # (its main-path entry, two a backbone call) and its NCHW
            # entry (on no path: its row is not held to a launch) in the
            # match_pair call of indoor_ds
            launches = {k: main_counts[k] for k in
                        ("coarse_layer", "dual_softmax", "fine_stage",
                         "upsample", "upsample_add")}
            launches["focal_loss"] = (train_counts["focal_loss_forward"]
                                      + train_counts["focal_loss_backward"])
            launches["sinkhorn"] = ot_counts["sinkhorn"]
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
            if serve_counts is not None:
                # phase 12's service run: 64 requests through A, B and C
                for name in ("coarse_layer", "dual_softmax", "fine_stage"):
                    extra.setdefault(name, {})["serve_launches"] = \
                        serve_counts[name]
            if sfm_counts is not None:
                # phase 13's SfM CLI run: one match call a keyframe pair
                for name in ("coarse_layer", "dual_softmax", "fine_stage"):
                    extra.setdefault(name, {})["sfm_launches"] = \
                        sfm_counts[name]
            if dp_counts is not None:
                # phase 14's data-parallel step: rank 0's launches
                for name, n in (("dual_softmax", dp_counts["dual_softmax"]),
                                ("focal_loss",
                                 dp_counts["focal_loss_forward"]
                                 + dp_counts["focal_loss_backward"])):
                    extra.setdefault(name, {})["dp_rank0_launches"] = n
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
                        "bound_ms_B2", "peak_mem_MiB_B2", "sites")
            # kernel G's NCHW entry, the JAX kernel's counterpart, runs on
            # no path since the FPN merge took its place
            on_path = set(results) - {"upsample"}
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
                    "bound_unit": r["bound_unit"],
                    "main_path": name in on_path, **extra.get(name, {}),
                    **{k: r[k] for k in optional if k in r}})
            check(len(kernels) == 8
                  and all(k["launches"] > 0 for k in kernels
                          if k["main_path"]),
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
