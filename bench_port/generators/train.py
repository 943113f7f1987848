"""Training: ``Trainer.train_step`` on padded, masked batches with depth,
pose and intrinsics, as the training CLI feeds it.

Set-up renders the mix's pairs on the card and keeps them as CPU
``MatchInput`` batches (images in [0, 1], depth, intrinsics, poses, coarse
masks, unit scales), as the CLI's loader yields them; builds one
``Trainer`` and one state from the seeded weights; and drives that state
through its first three steps on the first three batches, through the
window's own call.  Those steps are the warm-up and the check: their
losses, the first gradient as the optimizer holds it (AdamW's first moment
after one step, over 1 - beta1) and the parameters after the third step
are kept.  The window goes on from the fourth batch with the same state,
reading the scalars every ``log_every`` steps as the CLI logs them; a
rate is the pairs of every step launched in the window over the time until
the last of them has finished.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from bench_port import check
from bench_port.data.pairs import make_pairs
from bench_port.reference.loftr_plain import strict_float32
from bench_port.reference.train_plain import run_reference
from bench_port.weights import make_state


def program_config(cfg: dict):
    """The port's training config: the preset in bf16, the schedule of the
    configuration file (no warm-up, no epoch boundary in a run)."""
    from loftr_tpu_torch.config import get_config
    t = cfg["train"]
    return get_config(cfg["preset"], {
        "loftr": {"dtype": cfg["dtype"]},
        "trainer": {"canonical_bs": t["canonical_bs"],
                    "canonical_lr": t["canonical_lr"],
                    "warmup_step": t["warmup_step"],
                    "steps_per_epoch": t["steps_per_epoch"]}})


def reference_config(cfg: dict, B: int) -> dict:
    """The reference's step settings: the published optimizer and loss
    constants and the configuration's rate scaled to the batch."""
    t = cfg["train"]
    return {"lr": t["canonical_lr"] * B / t["canonical_bs"],
            "weight_decay": t["adamw_decay"], "betas": (0.9, 0.999),
            "eps": 1e-8, "clip": t["gradient_clipping"],
            "focal_alpha": 0.25, "focal_gamma": 2.0,
            "temperature": 0.1, "thr": t["thr"], "border_rm": 2,
            "train_coarse_percent": t["train_coarse_percent"],
            "train_pad_num_gt_min": 200}


def _moved(record: dict, dev) -> dict:
    """A copy of ``record`` with its tensors (one level of dicts deep) on
    ``dev``."""
    to = lambda v: v.to(dev) if torch.is_tensor(v) else v
    return {k: ({n: to(t) for n, t in v.items()} if isinstance(v, dict)
                else v) for k, v in record.items()}


class Train:
    kind = "train"

    def __init__(self, cell, seed: int, dev):
        self.seed, self.dev = seed, dev
        self.mix, self.cfg = cell.mix, cell.config
        self.B = self.mix["batch"]

    def _batches(self):
        from loftr_tpu_torch.structs import MatchInput
        P = self.pairs
        out = []
        for b in range(self.mix["pairs"] // self.B):
            s = slice(b * self.B, (b + 1) * self.B)
            ones = torch.ones((self.B, 2))
            out.append(MatchInput(
                image0=(P.image0[s].float() / 255.0)[..., None].cpu(),
                image1=(P.image1[s].float() / 255.0)[..., None].cpu(),
                mask0=P.mask0[s].cpu(), mask1=P.mask1[s].cpu(),
                scale0=ones, scale1=ones.clone(),
                depth0=P.depth0[s].cpu(), depth1=P.depth1[s].cpu(),
                T_0to1=P.T_0to1[s].cpu(), T_1to0=P.T_1to0[s].cpu(),
                K0=P.K0[s].cpu(), K1=P.K1[s].cpu()))
        return out

    def setup(self, steps=None) -> None:
        from loftr_tpu_torch.train.trainer import Trainer
        mix, dev = self.mix, self.dev
        self.state0 = make_state(self.cfg["widths"], self.seed, dev)
        self.pairs = make_pairs(self.seed, mix["pairs"], mix["views"],
                                mix["pad"], dev)
        self.batches = self._batches()
        self.trainer = Trainer(program_config(self.cfg),
                               batch_size_per_device=self.B, device=dev)
        cpu_state = {k: v.cpu() for k, v in self.state0.items()}
        self.ts = self.trainer.init_state(self.seed, state_dict=cpu_state)
        self.prog = self.first_steps(steps or self._step)

    def _step(self, batch):
        return self.trainer.train_step(self.ts, batch)

    def first_steps(self, step) -> dict:
        """Three steps through ``step`` (the window's call, or a broken
        one in the tests), on three distinct batches; what the check
        compares."""
        model = self.ts.module
        names = [n for n, _ in model.named_parameters()]
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        losses, coarse, grad1 = [], [], None
        b1 = self.ts.optimizer.param_groups[0]["betas"][0]
        for k in range(3):
            _, sc = step(self.batches[k])
            losses.append(float(sc["loss"]))
            coarse.append(float(sc["loss_c"]))
            if k == 0:
                first = {"loss_f": float(sc["loss_f"]),
                         "grad_norm": float(sc["grad_norm"])}
                grad1 = {n: self.ts.optimizer.state[p]["exp_avg"].detach()
                         .clone() / (1 - b1) if p in self.ts.optimizer.state
                         else torch.zeros_like(p)
                         for n, p in model.named_parameters()}
        delta = {n: p.detach() - p0[n] for n, p in model.named_parameters()}
        return {"losses": losses, "coarse": coarse, "first": first,
                "grad1": {n: grad1[n] for n in names},
                "delta": delta}

    def window(self, seconds: float) -> dict:
        nb = len(self.batches)
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            with record_function("bench.step"):
                _, sc = self.trainer.train_step(
                    self.ts, self.batches[(3 + steps) % nb])
            steps += 1
            if steps % self.mix["log_every"] == 0:
                with record_function("bench.log"):
                    float(sc["loss"])
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        self.window_steps = steps
        rate = steps * self.B / elapsed
        return {"attempted": steps, "failed": 0,
                "e2e": {"train_pairs_per_s": (rate, "pairs/s")},
                "rate": rate, "elapsed": elapsed, "steps": steps}

    def layer_info(self) -> dict:
        H, W = self.mix["pad"]
        L = (H // 8) * (W // 8)
        k = int(self.cfg["train"]["train_coarse_percent"] * L)
        return {"B": self.B, "L": L, "S": L, "K": k, "H": H, "W": W,
                "steps": self.window_steps}

    def free(self) -> None:
        self.prog = _moved(self.prog, "cpu")
        del self.ts, self.trainer

    def reference(self, quant=None) -> dict:
        strict_float32()
        batches = []
        for mi in self.batches[:3]:
            batches.append({
                "image0": mi.image0[..., 0].to(self.dev),
                "image1": mi.image1[..., 0].to(self.dev),
                **{k: getattr(mi, k).to(self.dev) for k in (
                    "mask0", "mask1", "scale0", "scale1", "depth0", "depth1",
                    "T_0to1", "T_1to0", "K0", "K1")}})
        return run_reference(self.state0, self.cfg["widths"],
                             reference_config(self.cfg, self.B), self.seed,
                             batches, self.dev, quant)

    def check(self) -> dict:
        ref = self.reference()
        return check.judge_train(_moved(self.prog, self.dev), ref)


Generator = Train
