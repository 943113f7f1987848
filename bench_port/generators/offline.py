"""Offline matching: batches of pairs through ``LoFTR.forward`` as fast as
the card takes them.

Set-up renders the mix's pairs on the card, keeps them as uint8 in pinned
host memory, builds the port's matcher from the seeded weights through
``api.optimize_variables`` (BatchNorm folded, 196 -> 256 channels, as
serving runs it) and warms the one batch shape.  The window cycles through
the batches: each is copied in, divided by 255 on the card, matched under
``inference_mode``, and its outputs (valid, mconf, both refined keypoint
sets and the coarse cell ids) packed and copied back into pinned memory
behind an event; ``in_flight`` batches are kept launched ahead.  A batch
counts when its event has completed inside the window.  The check draws
``check_batches`` of the window's completed batches from the seed and
judges every pair of them against the reference.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch
from torch.profiler import record_function

from bench_port import check
from bench_port.data.pairs import make_pairs
from bench_port.reference.loftr_plain import Plain, strict_float32
from bench_port.weights import make_state


def program_overrides(cfg: dict) -> dict:
    """The port's config overrides for inference with this configuration."""
    inf = cfg["inference"]
    return {"dtype": cfg["dtype"],
            "match_coarse": {"thr": inf["thr"],
                             "max_matches": inf["max_matches"]}}


def build_matcher(cfg: dict, state: dict, dev):
    """The port's matcher on the seeded weights, transformed as serving
    transforms them."""
    from loftr_tpu_torch.api import (load_matcher, optimize_variables,
                                     with_config)
    sd = optimize_variables({k: v.detach() for k, v in state.items()})
    model = load_matcher(preset=cfg["preset"], device=dev, state_dict=sd)
    return with_config(model, program_overrides(cfg))


class Offline:
    kind = "offline"

    def __init__(self, cell, seed: int, dev):
        self.seed, self.dev = seed, dev
        self.mix, self.cfg = cell.mix, cell.config
        self.B = self.mix["batch"]

    # ----------------------------------------------------------- set-up
    def setup(self) -> None:
        mix, dev = self.mix, self.dev
        self.state = make_state(self.cfg["widths"], self.seed, dev)
        self.model = build_matcher(self.cfg, self.state, dev)
        self.pairs = make_pairs(self.seed, mix["pairs"], mix["views"],
                                mix["pad"], dev)
        self.masked = any((v[0], v[1]) != tuple(mix["pad"]) or
                          (v[2], v[3]) != tuple(mix["pad"])
                          for v in mix["views"])
        n = mix["pairs"] // self.B
        cuda = dev.type == "cuda"
        pin = lambda t: t.cpu().pin_memory() if cuda else t.cpu()
        self.batches = []
        for b in range(n):
            s = slice(b * self.B, (b + 1) * self.B)
            rec = {"image0": pin(self.pairs.image0[s, ..., None]),
                   "image1": pin(self.pairs.image1[s, ..., None])}
            if self.masked:
                rec["mask0"] = pin(self.pairs.mask0[s])
                rec["mask1"] = pin(self.pairs.mask1[s])
            self.batches.append(rec)
        self._255 = torch.tensor(255.0, device=dev)
        self.K = self.cfg["inference"]["max_matches"]
        self._run(None, mix["warmup_batches"])

    # ------------------------------------------------------------ window
    def _launch(self, b: int):
        from loftr_tpu_torch.structs import MatchInput
        with record_function("bench.batch"):
            host = self.batches[b]
            dev = {k: v.to(self.dev, non_blocking=True)
                   for k, v in host.items()}
            dev["image0"] = dev["image0"].float() / self._255
            dev["image1"] = dev["image1"].float() / self._255
            with torch.inference_mode():
                out = self.model(MatchInput(**dev))
                f32 = torch.float32
                packed = torch.cat([
                    out.valid[..., None].to(f32),
                    out.coarse.mconf[..., None].to(f32),
                    out.mkpts0_f.to(f32), out.mkpts1_f.to(f32),
                    out.coarse.i_ids[..., None].to(f32),
                    out.coarse.j_ids[..., None].to(f32)], -1)
            if packed.device.type != "cuda":
                return packed, None
            res = torch.empty(packed.shape, dtype=f32, pin_memory=True)
            res.copy_(packed, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        return res, ev

    def _run(self, seconds, n_batches=None):
        """Launch batches until ``seconds`` pass (or ``n_batches`` are
        launched); returns the batches completed in time, each (index of the
        batch, host result)."""
        nb = len(self.batches)
        t0 = time.perf_counter()
        t_end = None if seconds is None else t0 + seconds
        queue, done, launched = [], [], 0

        def finish():
            b, res, ev = queue.pop(0)
            if ev is not None:
                with record_function("bench.wait"):
                    ev.synchronize()
            if t_end is None or time.perf_counter() <= t_end:
                done.append((b, res.numpy().copy()))

        while True:
            if n_batches is not None and launched >= n_batches:
                break
            if t_end is not None and time.perf_counter() >= t_end:
                break
            b = launched % nb
            res, ev = self._launch(b)
            queue.append((b, res, ev))
            launched += 1
            if len(queue) >= self.mix["in_flight"]:
                finish()
        while queue:
            finish()
        self.launched = launched
        return done

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        self.done = self._run(seconds)
        elapsed = time.perf_counter() - t0
        pairs = len(self.done) * self.B
        return {"attempted": self.launched * self.B, "failed": 0,
                "e2e": {"pairs_per_s": (pairs / seconds, "pairs/s")},
                "rate": pairs / seconds, "elapsed": elapsed}

    def layer_info(self) -> dict:
        H, W = self.mix["pad"]
        L = (H // 8) * (W // 8)
        return {"B": self.B, "L": L, "S": L, "K": self.K, "H": H, "W": W}

    def free(self) -> None:
        del self.model
        self.batches = None

    # ------------------------------------------------------------- check
    def check(self) -> dict:
        rng = np.random.default_rng(self.seed)
        n = min(self.mix["check_batches"], len(self.done))
        picks = rng.choice(len(self.done), size=n, replace=False)
        return judge_outputs(self, [self.done[k] for k in sorted(picks)])


def judge_outputs(drv, outputs: List[tuple]) -> dict:
    """Judge packed batch outputs [(batch index, [B, K, 8])] of generator
    ``drv`` against the float32 reference."""
    strict_float32()
    model = Plain(drv.state, drv.cfg["widths"])
    inf, P = drv.cfg["inference"], drv.pairs
    per_pair, refs = [], {}
    for b, res in outputs:
        for r in range(drv.B):
            p = b * drv.B + r
            if p not in refs:
                refs[p] = check.ref_pair(
                    model, P.image0[p].float() / 255.0,
                    P.image1[p].float() / 255.0,
                    P.mask0[p] if drv.masked else None,
                    P.mask1[p] if drv.masked else None, inf)
            v = res[r, :, 0] > 0.5
            per_pair.append(check.judge_pair(
                refs[p], res[r, v, 6].astype(np.int64),
                res[r, v, 7].astype(np.int64), res[r, v, 1],
                res[r, v, 2:4], res[r, v, 4:6]))
    return check.summarize_matches(per_pair)


Generator = Offline
