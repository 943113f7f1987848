"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload indoor_ds.match_b8 --seed 7 \
        --seconds 30 --trace 0

The cell's files are found by name: ``workloads/<cell>.json`` names its
configuration (``configs/``) and traffic mix (``traffic/``); the mix's
``generator`` names the code that reads it
(``generators/<generator>.py``).  Set-up (weights and inputs made on the
card from the seed, the program built and its shapes warmed) counts into
``setup_s``; then the window runs for ``--seconds``.  With
``--trace 1`` the window runs under ``torch.profiler`` and the per-layer
metrics (``metrics/<name>.py``) are read instead of the end-to-end ones.
After the window the program's state is freed and the plain reference
judges the outputs the window produced (``check.py``); each compared number
and its limit are printed last on standard error and under ``checks`` in
the result line, the last line of standard output.

Needs CUDA: without it, or with fewer cards than the cell asks for, the run
exits with code 2 and prints no result; so it does when JAX or the JAX
package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache the program or a library may write stays in the checkout, at
# fixed paths (the port builds its kernels under build/loftr_tpu_torch/)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build",
                                                       "triton"))
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(ROOT, "build",
                                                      "cuda_cache"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port import core  # noqa: E402


def make_generator(cell, seed, dev):
    """The generator the mix names: ``Generator`` of
    ``generators/<generator>.py``."""
    import importlib
    mod = importlib.import_module("bench_port.generators."
                                  + cell.mix["generator"])
    return mod.Generator(cell, seed, dev)


def measure(cell, seed: int, seconds: float, trace: bool, dev,
            t_start: float = None) -> core.Result:
    """One run of ``cell`` on ``dev``: set-up, the window, the check."""
    import torch
    from bench_port import trace as tr
    cuda = dev.type == "cuda"
    drv = make_generator(cell, seed, dev)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - (T_START if t_start is None else t_start)
    counts0 = launch_counts()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.start()
        with record_function(tr.WINDOW):
            res = drv.window(seconds)
        prof.stop()
    else:
        res = drv.window(seconds)
    launches = {k: v - counts0.get(k, 0) for k, v in launch_counts().items()}
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = core.Result(attempted=res["attempted"], failed=res["failed"])
    out.device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                  "count": 1,
                  "memory_peak_bytes": int(max(window_peak,
                                               setup_peak if cuda else 0))}
    if not trace:
        for name, (value, unit) in res["e2e"].items():
            out.metrics[name] = {"value": value, "unit": unit}
        out.metrics["peak_mem_gib"] = {"value": window_peak / 2 ** 30,
                                       "unit": "GiB"}
        out.metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        t = tr.collect(prof) if cuda else tr.Trace(res.get(
            "elapsed", seconds))
        ctx = {"kind": drv.kind, "trace": t, "launches": launches,
               "rate": res["rate"], "window_s": t.window_s,
               "cfg": cell.config, **drv.layer_info()}
        for name, reader in core.metric_readers().items():
            value = reader.read(ctx)
            if value is not None:
                out.metrics[name] = {"value": value, "unit": reader.UNIT}
        out.device["busy_s"] = tr.busy_s(t)
        out.device["window_s"] = t.window_s
        out.breakdown = tr.breakdown(t)
        del prof
    drv.free()
    if cuda:
        torch.cuda.empty_cache()
    limits = cell.limits
    for name, value in drv.check().items():
        if name in limits:
            out.checks.append(core.Check(name, float(value), limits[name]))
        else:
            out.readings[name] = value
    return out


def launch_counts() -> dict:
    from loftr_tpu_torch.ops.kernels import launch_counts as lc
    return lc()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = core.load_cell(args.workload)
    import torch
    chips = cell.workload.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        core.say(f"{args.workload} needs {chips} CUDA device(s); found "
                 f"{found}")
        return 2
    dev = torch.device("cuda", 0)
    core.say(f"card: {core.power_limit()}")
    out = measure(cell, args.seed, args.seconds, bool(args.trace), dev)
    bad = core.forbidden_loaded(sys.modules)
    if bad:
        core.say("forbidden modules loaded: " + ", ".join(bad))
        return 2
    for name, value in out.readings.items():
        core.say(f"reading {name}: {value}")
    for c in out.checks:
        core.say(f"check {c.name}: {c.value!r} (limit {c.limit!r})"
                 f"{'' if c.ok else '  FAILED'}")
    print(out.line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
