#!/usr/bin/env python3
"""Compare the SASS of the port's kernels between two source trees, function
by function (needs ``nvcc`` and ``cuobjdump``: run it on the CUDA machine).

    python3 tools/sass_compare.py OLD_CSRC NEW_CSRC [name.cu ...] [--out DIR]

Each named source (default: every ``.cu`` in NEW_CSRC) is compiled from both
directories with the production build's flags (``ops/kernels/_build.py``),
one ``nvcc`` a file, all started together, into ``build/sass_compare/``;
``cuobjdump -sass`` of each object is split into its functions, and each
function's code is normalised (the anonymous-namespace hash
``_GLOBAL__N__<hex>_<n>_<file>_cu_<hex>`` and the ``identifier`` lines
removed, runs of blanks collapsed) before it is compared.  Prints one JSON
object a source: functions identical, differing, only in OLD, only in NEW;
with ``--out`` it also writes each side's normalised SASS there.  Exits 1 if
a function present in both trees differs.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(text):
    text = re.sub(r"\d*_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "",
                  text)
    # cuobjdump pads its columns to the widest instruction of the object,
    # so runs of blanks carry no meaning
    return "\n".join(" ".join(line.split()) for line in text.splitlines()
                     if "identifier =" not in line)


def functions(obj):
    """{function name: normalised SASS} of one object file."""
    from loftr_tpu_torch.ops.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                         text=True, check=True).stdout
    funcs = {}
    for part in re.split(r"\n\s*Function : ", _norm(out))[1:]:
        name, _, body = part.partition("\n")
        funcs[name.strip()] = body.strip()
    return funcs


def compile_objs(jobs):
    """[(source, object)] -> objects, one nvcc each, all started together."""
    from loftr_tpu_torch.ops.kernels import _build
    procs = []
    for src, obj in jobs:
        os.makedirs(os.path.dirname(obj), exist_ok=True)
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-c",
             src, "-o", obj]))
    for p, (src, _) in zip(procs, jobs):
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for {src}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("sources", nargs="*")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    names = args.sources or sorted(
        n for n in os.listdir(args.new) if n.endswith(".cu"))
    work = os.path.join(REPO, "build", "sass_compare")
    obj = {(tag, name): os.path.join(work, tag, name + ".o")
           for tag in ("old", "new") for name in names}
    compile_objs([(os.path.join(getattr(args, tag), name), o)
                  for (tag, name), o in obj.items()])
    bad = False
    for name in names:
        side = {}
        for tag in ("old", "new"):
            side[tag] = functions(obj[(tag, name)])
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(args.out, f"{name}.{tag}.sass"),
                          "w") as f:
                    for fn in sorted(side[tag]):
                        f.write(f"Function : {fn}\n{side[tag][fn]}\n\n")
        old, new = side["old"], side["new"]
        common = sorted(set(old) & set(new))
        differ = [f for f in common if old[f] != new[f]]
        bad |= bool(differ)
        print(json.dumps({
            "source": name, "identical": len(common) - len(differ),
            "differ": differ, "only_old": sorted(set(old) - set(new)),
            "only_new": sorted(set(new) - set(old))}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
