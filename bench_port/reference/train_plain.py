"""Plain float32 LoFTR training steps, the reference for the port's
``Trainer.train_step``.

A frozen copy of the published step (zju3dv/LoFTR ``lightning_loftr.py``
:84-93 with ``supervision.py``, ``geometry.py`` and ``loftr_loss.py``):
coarse ground truth by warping each coarse grid with depth, pose and
intrinsics and keeping mutual cells; the training forward with BatchNorm on
batch statistics; the training selection (at most K - 200 predicted
matches, drawn by priority, the rest ground truth drawn with replacement);
the dense focal coarse loss and the fine L2 loss weighted by the inverse
standard deviation; gradients clipped to a global norm; AdamW.  The
selection's uniform draws are taken from a generator seeded as the
program's is, in the order the published step draws them (rows, ground-
truth rows, ground-truth picks).

Memory: the [L, S] focal terms are formed one pair at a time and
differentiated at once, their gradients gathered on detached copies of the
coarse features, then carried through the rest of the graph.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from bench_port.reference.loftr_plain import (Plain, border_ok, soft_argmax,
                                              windows)


def _apply3(m, v):
    return (m[:, None, :, :] * v[:, :, None, :]).sum(-1)


@torch.no_grad()
def warp(kpts0, depth0, depth1, T, K0, K1):
    """Warp pixels of image 0 into image 1: [B, L, 2] -> [B, L, 2]."""
    b, h, w = depth0.shape
    k = torch.round(kpts0).long()
    d0 = torch.gather(depth0.reshape(b, -1), 1,
                      (k[..., 1].clamp(0, h - 1) * w
                       + k[..., 0].clamp(0, w - 1)))
    hom = torch.cat([kpts0, torch.ones_like(kpts0[..., :1])], -1) \
        * d0[..., None]
    cam = _apply3(torch.linalg.inv(K0), hom)
    cam1 = _apply3(T[:, :3, :3], cam) + T[:, None, :3, 3]
    px = _apply3(K1, cam1)
    return px[..., :2] / (px[..., 2:3] + 1e-4)


def _grid(hc, wc, b, dev):
    ys, xs = torch.meshgrid(torch.arange(hc, device=dev, dtype=torch.float32),
                            torch.arange(wc, device=dev, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([xs, ys], -1).reshape(1, hc * wc, 2).expand(b, -1, -1)


@torch.no_grad()
def coarse_truth(batch: dict, res: int = 8):
    """(gt_j [B, L], gt_valid [B, L], warped grid 0 [B, L, 2], grid 1
    [B, S, 2]) in pixels."""
    B, H0, W0 = batch["image0"].shape
    _, H1, W1 = batch["image1"].shape
    h0, w0, h1, w1 = H0 // res, W0 // res, H1 // res, W1 // res
    dev = batch["image0"].device
    s0 = res * batch["scale0"][:, None, :]
    s1 = res * batch["scale1"][:, None, :]
    g0 = _grid(h0, w0, B, dev) * s0
    g1 = _grid(h1, w1, B, dev) * s1
    m0 = batch["mask0"].reshape(B, -1, 1)
    m1 = batch["mask1"].reshape(B, -1, 1)
    g0 = torch.where(m0, g0, torch.zeros_like(g0))
    g1 = torch.where(m1, g1, torch.zeros_like(g1))
    w01 = warp(g0, batch["depth0"], batch["depth1"], batch["T_0to1"],
               batch["K0"], batch["K1"])
    w10 = warp(g1, batch["depth1"], batch["depth0"], batch["T_1to0"],
               batch["K1"], batch["K0"])

    def cells(p, s, w, h):
        r = torch.round(p / s)
        r = torch.where(torch.isfinite(r) & (r.abs() < 2 ** 30), r,
                        torch.full_like(r, -1.0)).long()
        ok = (r[..., 0] >= 0) & (r[..., 0] < w) & (r[..., 1] >= 0) & \
            (r[..., 1] < h)
        return torch.where(ok, r[..., 0] + r[..., 1] * w,
                           torch.zeros_like(r[..., 0]))

    n1 = cells(w01, s1, w1, h1)
    n0 = cells(w10, s0, w0, h0)
    back = torch.gather(n0, 1, n1)
    valid = back == torch.arange(h0 * w0, device=dev)[None]
    valid[:, 0] = False
    return n1, valid, w01, g1


def select(valid, j, conf, gt_j, gt_valid, noise, k, pad_min, budget):
    """The training selection of one batch (every tensor [B, L] but the
    noise's picks [B, k] and the budget [B])."""
    B, L = valid.shape
    dev = valid.device
    slot = torch.arange(k, device=dev)[None]
    eff = budget.clamp(pad_min + 1, k)[:, None]
    neg = torch.full((), -1.0, device=dev)
    pri = torch.where(valid, noise["pred"], neg)
    order = torch.sort(pri, dim=1, descending=True, stable=True).indices[:, :k]
    take = torch.gather(valid, 1, order) & (slot < eff - pad_min)
    gpri = torch.where(gt_valid, noise["gt_sel"], neg)
    gorder = torch.sort(gpri, dim=1, descending=True, stable=True).indices
    n_gt = gt_valid.sum(1)
    pick = torch.floor(noise["gt_pick"] * n_gt.clamp_min(1)[:, None]
                       ).long().clamp(0, L - 1)
    rows = torch.gather(gorder, 1, pick)
    cols = torch.gather(gt_j, 1, rows)
    has = (n_gt > 0)[:, None]
    rows = torch.where(has, rows, torch.zeros_like(rows))
    cols = torch.where(has, cols, torch.zeros_like(cols))
    i_ids = torch.where(take, order, rows)
    j_ids = torch.where(take, torch.gather(j, 1, order), cols)
    return i_ids, j_ids, (slot < eff).expand(B, k)


def _conf(c0, c1, m0, m1, temperature):
    C = c0.shape[-1]
    sim = (c0 / C ** 0.5) @ (c1 / C ** 0.5).t() / temperature
    pair = m0[:, None] & m1[None, :]
    sim = torch.where(pair, sim, torch.full_like(sim, -1e9))
    return torch.softmax(sim, 0) * torch.softmax(sim, 1)


class RefTrainer:
    """Three or more reference steps from ``state`` (the benchmark's
    float32 state dict).  ``cfg``: the configuration file's ``train``
    block (lr, weight decay, betas, eps, clip, focal alpha and gamma,
    temperature, thr, border, train percent, pad minimum)."""

    def __init__(self, state: Dict[str, torch.Tensor], widths: dict,
                 cfg: dict, seed: int, device, quant: Optional[str] = None):
        self.p = {k: v.detach().clone().float().requires_grad_(
            not k.endswith(("running_mean", "running_var",
                            "num_batches_tracked")))
            for k, v in state.items()}
        self.names = [k for k, v in self.p.items() if v.requires_grad]
        self.widths, self.cfg, self.quant = widths, cfg, quant
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.m = {k: torch.zeros_like(self.p[k]) for k in self.names}
        self.v = {k: torch.zeros_like(self.p[k]) for k in self.names}
        self.t = 0

    def _loss_backward(self, batch: dict) -> float:
        c = self.cfg
        model = Plain(self.p, self.widths, self.quant, train=True)
        B = batch["image0"].shape[0]
        gt_j, gt_valid, w_pt0, pt1 = coarse_truth(batch)
        c0, c1, f0, f1, m0, m1 = model.features(
            batch["image0"], batch["image1"], batch["mask0"],
            batch["mask1"])
        L, S = c0.shape[1], c1.shape[1]
        hw0 = tuple(batch["mask0"].shape[1:])
        hw1 = tuple(batch["mask1"].shape[1:])
        k = int(c["train_coarse_percent"] * max(L, S))
        noise = {}
        for name, shape in (("pred", (B, L)), ("gt_sel", (B, L)),
                            ("gt_pick", (B, k))):
            u = torch.rand(shape, generator=self.gen, device=c0.device)
            noise[name] = 0.1 + 0.9 * u if name != "gt_pick" else u
        # candidates and the mask-aware budget, without gradients
        cand_v, cand_j, cand_c = [], [], []
        with torch.no_grad():
            for b in range(B):
                conf = _conf(c0[b], c1[b], m0[b], m1[b], c["temperature"])
                rv, rj = conf.max(1)
                cmax = conf.amax(0)
                ok = (rv > c["thr"]) & (rv >= cmax[rj]) & \
                    border_ok(hw0, c["border_rm"], batch["mask0"][b]) & \
                    border_ok(hw1, c["border_rm"], batch["mask1"][b])[rj]
                cand_v.append(ok)
                cand_j.append(rj)
                cand_c.append(rv)
                del conf

            def extent(mk):
                mi = mk.int()
                return mi.sum(1).amax(-1) * mi.sum(2).amax(-1)
            budget = torch.floor(c["train_coarse_percent"] * torch.minimum(
                extent(batch["mask0"]), extent(batch["mask1"])).float()
            ).long()
        i_ids, j_ids, slot_mask = select(
            torch.stack(cand_v), torch.stack(cand_j), torch.stack(cand_c),
            gt_j, gt_valid, noise, k, c["train_pad_num_gt_min"], budget)
        # the focal terms a pair at a time, on detached coarse features
        c0d = c0.detach().requires_grad_(True)
        c1d = c1.detach().requires_grad_(True)
        n_pos = gt_valid.sum().float()
        n_neg = float(B * L * S) - n_pos
        a, g = c["focal_alpha"], c["focal_gamma"]
        loss_c = 0.0
        for b in range(B):
            conf = _conf(c0d[b], c1d[b], m0[b], m1[b], c["temperature"])
            conf = conf.clamp(1e-6, 1 - 1e-6)
            w = (m0[b][:, None] & m1[b][None, :]).float()
            pos = torch.zeros_like(conf, dtype=torch.bool)
            rows = torch.nonzero(gt_valid[b])[:, 0]
            pos[rows, gt_j[b][rows]] = True
            lp = torch.where(pos, -a * (1 - conf) ** g * torch.log(conf),
                             torch.zeros_like(conf))
            ln = torch.where(pos, torch.zeros_like(conf),
                             -a * conf ** g * torch.log1p(-conf))
            term = (lp * w).sum() / n_pos.clamp_min(1) + \
                (ln * w).sum() / n_neg.clamp_min(1)
            term.backward()
            loss_c += float(term.detach())
            del conf, lp, ln, term
        # fine stage on the selected windows
        ww = 25
        e0 = []
        for b in range(B):
            ib, jb = i_ids[b], j_ids[b]
            win0 = windows(f0[b], ib, hw0[1], 5, f0.shape[1] // hw0[0])
            win1 = windows(f1[b], jb, hw1[1], 5, f1.shape[1] // hw1[0])
            ctx = model.linear("fine_preprocess.down_proj",
                               torch.cat([c0d[b][ib], c1d[b][jb]]), True)
            kk = ib.shape[0]

            def merge(win, cc):
                return model.linear("fine_preprocess.merge_feat", torch.cat(
                    [win, cc[:, None, :].expand(-1, ww, -1)], -1), True)

            w0, w1 = model.stack("loftr_fine", ["self", "cross"],
                                 merge(win0, ctx[:kk]), merge(win1, ctx[kk:]))
            e0.append(soft_argmax(w0, w1))
        expec = torch.stack(e0)
        with torch.no_grad():
            p0 = torch.gather(w_pt0, 1, i_ids[..., None].expand(-1, -1, 2))
            p1 = torch.gather(pt1, 1, j_ids[..., None].expand(-1, -1, 2))
            scale = 2 * batch["scale1"][:, None, :]
            gt = (p0 - p1) / scale / 2
        correct = (gt.abs().amax(-1) < 1.0) & slot_mask
        inv = 1.0 / expec[..., 2].clamp_min(1e-10)
        sm = slot_mask.float()
        mean_inv = ((inv.detach() * sm).sum() / sm.sum().clamp_min(1))
        weight = (inv / mean_inv.clamp_min(1e-10)).detach()
        l2 = ((gt - expec[..., :2]) ** 2).sum(-1)
        cf = correct.float()
        loss_f = (l2 * weight * cf).sum() / cf.sum().clamp_min(1)
        # the largest weight a correct slot takes: flat heatmaps of an
        # untrained net give a few slots most of the fine loss
        self.weight_max = float((weight * cf).max())
        loss_f.backward(retain_graph=True)
        torch.autograd.backward([c0, c1], [c0d.grad, c1d.grad])
        self.loss_c, self.loss_f = loss_c, float(loss_f.detach())
        return loss_c + float(loss_f.detach())

    def step(self, batch: dict) -> Dict[str, object]:
        """One step; returns the loss and the clipped gradients."""
        c = self.cfg
        for k in self.names:
            self.p[k].grad = None
        loss = self._loss_backward(batch)
        grads = {k: (self.p[k].grad if self.p[k].grad is not None
                     else torch.zeros_like(self.p[k])) for k in self.names}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        self.grad_norm = float(norm)
        factor = c["clip"] / max(float(norm), c["clip"])
        grads = {k: g * factor for k, g in grads.items()}
        self.t += 1
        b1, b2 = c["betas"]
        lr, wd, eps = c["lr"], c["weight_decay"], c["eps"]
        with torch.no_grad():
            for k in self.names:
                p, g = self.p[k], grads[k]
                p.mul_(1 - lr * wd)
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (self.v[k].sqrt()
                         / (1 - b2 ** self.t) ** 0.5).add_(eps)
                p.addcdiv_(self.m[k], denom, value=-lr / (1 - b1 ** self.t))
        return {"loss": loss, "grads": grads}

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: self.p[k].detach().clone() for k in self.names}


def run_reference(state, widths, cfg, seed, batches: List[dict], device,
                  quant=None) -> dict:
    """The reference's three steps: each step's loss and its coarse term,
    the first clipped gradient and the parameters' change, by parameter
    name."""
    rt = RefTrainer(state, widths, cfg, seed, device, quant)
    p0 = rt.params()
    losses, coarse, grad1 = [], [], None
    for n, batch in enumerate(batches):
        out = rt.step(batch)
        losses.append(out["loss"])
        coarse.append(rt.loss_c)
        if n == 0:
            first = {"loss_f": rt.loss_f, "grad_norm": rt.grad_norm,
                     "weight_max": rt.weight_max}
            grad1 = {k: v.detach().clone() for k, v in out["grads"].items()}
    p3 = rt.params()
    return {"losses": losses, "coarse": coarse, "first": first,
            "grad1": grad1,
            "delta": {k: p3[k] - p0[k] for k in p0}}
