#!/usr/bin/env python3
"""Scan batch seeds of tests/test_torch_train_step.py for ReLU mask flips.

    python tools/train_step_seed_scan.py [--seeds 0 1 2 ...] [--tensors]

For each seed it builds the test's JAX reference (two train steps of the
tiny model on the CPU, Pallas kernels in interpret mode) and runs the
port's CPU step from the same init, batch and selection noise.  It prints
one JSON line per seed: the largest gradient error as a share of the
tensor's largest entry (backbone and the rest), the number of gradient
entries beyond the test's bar (rtol 1e-3, atol 1e-3 of the largest entry),
and per step the number of parameter entries beyond rtol 2e-3 / atol 2e-5.
A seed whose batch puts a ReLU input of the backbone within the two
frameworks' float32 difference of zero shows a backbone gradient error of
about 1e-2; the others stay near 1e-4.  ``--tensors`` adds the error of
every tensor that is beyond the bar.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def scan(seed, tensors):
    import torch
    import test_torch_train_step as T
    ref = T.build_ref(seed)
    trainer, state = T._port_state(ref)
    batch = T.to_torch(ref["batch"])
    loss, _, _ = trainer.forward_loss(state, batch, ref["noise"][0])
    names = [n for n, _ in state.module.named_parameters()]
    got = torch.autograd.grad(loss, list(state.module.parameters()))
    worst = {"backbone": 0.0, "other": 0.0}
    n_bad, per_tensor = 0, {}
    for n, g in zip(names, got):
        w = ref["grads"][n].numpy()
        top = float(np.abs(w).max())
        d = np.abs(g.numpy() - w)
        key = "backbone" if n.startswith("backbone.") else "other"
        worst[key] = max(worst[key], float(d.max()) / top)
        bad = int((d > 1e-3 * np.abs(w) + 1e-3 * top).sum())
        n_bad += bad
        if bad:
            per_tensor[n] = {"max_err_of_top": float(d.max()) / top,
                             "beyond_bar": bad, "entries": int(d.size)}
    rec = {"seed": seed, "grad_max_err_of_top": worst,
           "grad_entries_beyond_bar": n_bad}
    trainer, state = T._port_state(ref)
    for i in (0, 1):
        state, sc = trainer.train_step(state, batch, ref["noise"][i])
        want = T.state_dict_from_jax(ref["after"][i])
        have = state.module.state_dict()
        bad = total = 0
        for k, w in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            d = np.abs(have[k].numpy() - w.numpy())
            bad += int((d > 2e-5 + 2e-3 * np.abs(w.numpy())).sum())
            total += d.size
        rec[f"step{i + 1}"] = {"lr": float(sc["lr"]),
                               "param_entries_beyond_bar": bad,
                               "param_entries": total}
    if tensors:
        rec["tensors_beyond_bar"] = per_tensor
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(14)))
    ap.add_argument("--tensors", action="store_true")
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    for seed in args.seeds:
        print(json.dumps(scan(seed, args.tensors)), flush=True)


if __name__ == "__main__":
    main()
