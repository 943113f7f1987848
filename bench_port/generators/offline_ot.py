"""Offline matching with LoFTR-OT: ``offline``'s batches, window and kind,
judged against the Sinkhorn reference (``reference/loftr_ot_plain.py``).

The seeded state gains the configuration's ``seeded`` entries (the
published ``bin_score`` and the last coarse LayerNorm's gain, each a value
filling its tensor), which the port and the reference both read.  The
port's matcher gets the configuration's Sinkhorn settings (``skh_iters``,
``skh_prefilter``) besides ``offline``'s; ``program_inference`` is what the
program runs and may differ from the reference's settings only where a
planted fault puts it (``control_ot.py``).  The check judges every pair
of the sampled batches through ``check.judge_pair`` and
``check.summarize_matches``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from bench_port import check
from bench_port.generators.offline import Offline
from bench_port.reference.loftr_ot_plain import PlainOT, ref_pair_ot
from bench_port.reference.loftr_plain import strict_float32


def ot_state(state: dict, cfg: dict) -> dict:
    """``state`` with each entry of ``cfg["seeded"]`` set to its value:
    ``coarse_matching.bin_score`` made as a scalar, a named tensor
    filled."""
    out = dict(state)
    for name, value in cfg["seeded"].items():
        like = out.get(name)
        if like is None:
            dev = next(iter(state.values())).device
            out[name] = torch.tensor(float(value), device=dev)
        else:
            out[name] = torch.full_like(like, float(value))
    return out


def program_overrides(cfg: dict, inf: dict) -> dict:
    """The port's config overrides for inference with settings ``inf``."""
    return {"dtype": cfg["dtype"],
            "match_coarse": {"thr": inf["thr"],
                             "max_matches": inf["max_matches"],
                             "skh_iters": inf["skh_iters"],
                             "skh_prefilter": inf["skh_prefilter"]}}


class OfflineOT(Offline):
    def __init__(self, cell, seed: int, dev):
        super().__init__(cell, seed, dev)
        self.program_inference = dict(self.cfg["inference"])

    # ``Offline.setup`` makes the seeded state and then the matcher from
    # it: the state it sets gains the OT entries on the way in
    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value):
        self._state = ot_state(value, self.cfg)

    @property
    def model(self):
        return self._model

    @model.setter
    def model(self, value):
        # ``Offline.setup`` builds the matcher with ``offline``'s overrides
        # (dtype, threshold, K); the Sinkhorn settings are laid over them
        from loftr_tpu_torch.api import with_config
        self._model = with_config(value, program_overrides(
            self.cfg, self.program_inference))

    @model.deleter
    def model(self):
        del self._model

    def judged(self) -> List[tuple]:
        """The window's batches that the check judges, drawn from the
        seed as ``Offline.check`` draws them."""
        rng = np.random.default_rng(self.seed)
        n = min(self.mix["check_batches"], len(self.done))
        picks = rng.choice(len(self.done), size=n, replace=False)
        return [self.done[k] for k in sorted(picks)]

    def check(self) -> dict:
        return judge_outputs_ot(self, self.judged())


def judged_pairs(drv, outputs: List[tuple]):
    """Each pair of packed batch outputs [(batch index, [B, K, 8])] of
    generator ``drv`` with its float32 Sinkhorn reference: (reference,
    (i, j, mconf, keypoints 0, keypoints 1) of the valid matches), one
    [L, S] confidence held at a time."""
    strict_float32()
    inf = drv.cfg["inference"]
    model = PlainOT(drv.state, drv.cfg["widths"], iters=inf["skh_iters"])
    P = drv.pairs
    for b, res in outputs:
        for r in range(drv.B):
            p = b * drv.B + r
            ref = ref_pair_ot(model, P.image0[p].float() / 255.0,
                              P.image1[p].float() / 255.0,
                              P.mask0[p] if drv.masked else None,
                              P.mask1[p] if drv.masked else None, inf)
            v = res[r, :, 0] > 0.5
            yield ref, (res[r, v, 6].astype(np.int64),
                        res[r, v, 7].astype(np.int64), res[r, v, 1],
                        res[r, v, 2:4], res[r, v, 4:6])
            del ref


def judge_outputs_ot(drv, outputs: List[tuple]) -> dict:
    """Judge packed batch outputs [(batch index, [B, K, 8])] of generator
    ``drv`` against the float32 Sinkhorn reference."""
    per_pair = []
    for ref, ans in judged_pairs(drv, outputs):
        per_pair.append(check.judge_pair(ref, *ans))
        del ref
    return check.summarize_matches(per_pair)


Generator = OfflineOT
