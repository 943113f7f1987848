"""JAX's own accuracy run on one seed's scenes from other initial weights,
on the CPU: the control for the port's per-seed accuracy bars.

Calls the JAX package's ``tools/synthetic_benchmark.py`` functions as its
``tools/seed_sweep.py`` does (``generate_data``, ``train``,
``evaluate_cli``; 6 train and 3 held-out scenes of 12 views at 256 px,
2000 steps at batch 4, lr 0.002, ``per_pair``, OpenCV at 1.5 px) and
changes one thing: the key of the initial weights.  ``train`` seeds the
data order and the init from one ``seed``; here ``jax.random.PRNGKey`` is
replaced while ``train`` runs, so that ``PRNGKey(seed)`` gives
``PRNGKey(init_seed)`` (the trainer's selection key derives from it, as
the port's ``--init-seeds`` does) while the scenes and the data order stay
those of ``seed``.

Usage (CPU, about an hour a run):
  python tests/torch_jax_inits.py --seed 2 --init-seed 1002 \\
      --work-dir build/jax_inits --out build/jax_inits/seed2_1002.json
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import os.path as osp
import sys
import time

HERE = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_synthetic_benchmark", osp.join(REPO, "tools",
                                            "synthetic_benchmark.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def init_key(seed: int, init_seed: int):
    """``jax.random.PRNGKey(seed)`` gives the key of ``init_seed`` while
    the block runs; every other seed is passed through."""
    orig = jax.random.PRNGKey

    def key(s, *a, **kw):
        return orig(init_seed if int(s) == seed else s, *a, **kw)

    jax.random.PRNGKey = key
    try:
        yield
    finally:
        jax.random.PRNGKey = orig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--init-seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--work-dir", default=osp.join(REPO, "build",
                                                   "jax_inits"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tool = _jax_tool()
    wd = osp.join(args.work_dir, f"seed{args.seed}_init{args.init_seed}")
    os.makedirs(wd, exist_ok=True)
    t0 = time.time()
    train_npzs, test_idx = tool.generate_data(wd, 6, 3, 12, 256, args.seed)
    with init_key(args.seed, args.init_seed):
        ckpt, losses = tool.train(wd, train_npzs, 256, 256, args.steps, 4,
                                  2e-3, args.seed, train_sampling="per_pair")
    train_s = time.time() - t0
    res = tool.evaluate_cli(wd, test_idx, ckpt, 256,
                            extra_env={"JAX_PLATFORMS": "cpu"})
    out = {"seed": args.seed, "init_seed": args.init_seed,
           "steps": args.steps, **res,
           "train_loss_last20": float(sum(losses[-20:]) / 20),
           "train_s": round(train_s, 1),
           "wall_s": round(time.time() - t0, 1),
           "platform": "cpu (jax " + jax.__version__ + ")"}
    print(json.dumps(out))
    if args.out:
        os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
