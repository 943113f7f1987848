"""Plain float32 LoFTR-OT: the benchmark's reference for the Sinkhorn
matcher (``MATCH_TYPE = 'sinkhorn'``).

Backbone, position encoding, coarse transformer and fine stage are
:class:`~bench_port.reference.loftr_plain.Plain`'s; this file adds the
published coarse matching of zju3dv/LoFTR ``src/loftr/utils/
coarse_matching.py`` with SuperGlue's ``log_optimal_transport``:

- ``sim = <f0, f1> / C`` (both features over ``sqrt(C)``), masked pairs at
  -1e9;
- couplings ``[[sim, alpha], [alpha, alpha]]`` with the learned scalar
  ``coarse_matching.bin_score``;
- marginals ``norm = -log(L + S)`` for every real row and column,
  ``log(S) + norm`` for the dustbin row and ``log(L) + norm`` for the
  dustbin column, over the padded L and S as ``scores.shape`` gives them;
- ``iters`` log-domain iterations from zero potentials, ``u`` first;
- ``conf = exp(Z + u + v - norm)[:L, :S]``, then threshold, mutual
  nearest and border removal as the dual-softmax reference does them.

It materialises the [L+1, S+1] coupling of one pair at a time (486 MB at
840 px in float32).  It imports no JAX and nothing of ``loftr_tpu_torch``.
``quant="fp8"`` rounds the operands of the similarity product too (the
control); the iterations stay float32.

Departures from the published code, none of which changes the function:

- one pair at a time, ``[L+1, S+1]`` without the batch axis;
- ``skh_prefilter`` is not implemented (published off); the cells run
  without it;
- the fine stage runs only at the program's matches (``check.py``), as
  the dual-softmax reference does;
- the top-K cap (``max_matches``) and the stable tie order follow the
  port's static capacity, as ``loftr_plain.match_pair`` does;
- the variants ``iters`` other than 3 and ``dustbin=False`` (couplings
  and marginals without the dustbin row and column) exist only to plant
  faults (``control_ot.py``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from bench_port.reference.loftr_plain import INF, Plain, border_ok

BIN_SCORE = "coarse_matching.bin_score"


def log_optimal_transport(sim: torch.Tensor, alpha: torch.Tensor,
                          iters: int, dustbin: bool = True) -> torch.Tensor:
    """SuperGlue's ``log_optimal_transport`` on one pair: sim [L, S] ->
    the log assignment [L+1, S+1] (dustbins last) shifted by ``-norm``
    (multiplied by L + S).  ``dustbin=False`` drops the dustbin row and
    column (a planted fault): [L, S]."""
    L, S = sim.shape
    norm = -math.log(L + S)
    if dustbin:
        a = alpha.reshape(()).to(sim.dtype)
        z = torch.cat([torch.cat([sim, a.expand(L, 1)], 1),
                       a.expand(1, S + 1)], 0)
        log_mu = sim.new_full((L + 1,), norm)
        log_mu[L] = math.log(S) + norm
        log_nu = sim.new_full((S + 1,), norm)
        log_nu[S] = math.log(L) + norm
    else:
        z = sim
        log_mu = sim.new_full((L,), norm)
        log_nu = sim.new_full((S,), norm)
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(z + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(z + u[:, None], dim=0)
    return z + u[:, None] + v[None, :] - norm


class OTConf:
    """The Sinkhorn confidence of one pair, held whole: ``conf`` [L, S],
    with the interface of ``loftr_plain.PairConf`` that ``check.py``
    reads (``conf_rows``, ``best``)."""

    def __init__(self, c0, c1, m0, m1, alpha, iters: int,
                 q=lambda t: t, dustbin: bool = True):
        C = c0.shape[-1]
        sim = q(c0.float() / C ** 0.5) @ q(c1.float() / C ** 0.5).t()
        if m0 is not None:
            pair = m0.bool()[:, None] & m1.bool()[None, :]
            sim = torch.where(pair, sim, torch.full_like(sim, -INF))
        L, S = sim.shape
        z = log_optimal_transport(sim, alpha, iters, dustbin)
        del sim
        self.conf = z[:L, :S].exp()

    def conf_rows(self, rows):
        return self.conf[rows]

    def best(self):
        """Per row (best conf, its column) and per column (best conf, its
        row)."""
        rv, rj = self.conf.max(dim=1)
        cv, ci = self.conf.max(dim=0)
        return rv, rj, cv, ci


class PlainOT(Plain):
    """:class:`Plain` with the Sinkhorn matcher.  ``iters`` and
    ``dustbin`` plant faults."""

    def __init__(self, p, widths: dict, quant: Optional[str] = None,
                 iters: int = 3, dustbin: bool = True):
        super().__init__(p, widths, quant)
        self.iters, self.dustbin = iters, dustbin
        self.alpha = p[BIN_SCORE].float()

    def coarse_conf(self, c0, c1, m0, m1) -> OTConf:
        return OTConf(c0, c1, m0, m1, self.alpha, self.iters, self.q,
                      self.dustbin)


def match_pair_ot(model: PlainOT, c0, c1, m0, m1, hw0, hw1, thr: float,
                  border: int, k: int, mask0=None, mask1=None):
    """Coarse matches of one pair by the published rule over the Sinkhorn
    confidence: conf > thr, mutual nearest, border removed, then the top
    ``k`` (a stable order: ties keep the lower row).  Returns what
    ``loftr_plain.match_pair`` returns."""
    conf = model.coarse_conf(c0, c1, m0, m1)
    rv, rj, cv, ci = conf.best()
    ok0 = border_ok(hw0, border, mask0).to(rv.device)
    ok1 = border_ok(hw1, border, mask1).to(rv.device)
    valid = (rv > thr) & (rv >= cv[rj]) & ok0 & ok1[rj]
    score = torch.where(valid, rv, torch.full_like(rv, -1.0))
    order = torch.sort(score, descending=True, stable=True).indices[:k]
    keep = valid[order]
    i_ids = order[keep]
    return conf, (rv, rj, cv, ci), i_ids, rj[i_ids], rv[i_ids]


def ref_pair_ot(model: PlainOT, img0, img1, mask0, mask1, cfg: dict) -> dict:
    """The reference of one pair, as ``check.ref_pair`` gives it for the
    dual-softmax model: images [H, W] float in [0, 1], coarse masks
    [h, w] or None."""
    m0 = None if mask0 is None else mask0[None]
    m1 = None if mask1 is None else mask1[None]
    with torch.no_grad():
        c0, c1, f0, f1, mm0, mm1 = model.features(img0[None], img1[None],
                                                  m0, m1)
        hw0 = (img0.shape[0] // 8, img0.shape[1] // 8)
        hw1 = (img1.shape[0] // 8, img1.shape[1] // 8)
        conf, best, i_r, j_r, v_r = match_pair_ot(
            model, c0[0], c1[0], None if mm0 is None else mm0[0],
            None if mm1 is None else mm1[0], hw0, hw1, cfg["thr"],
            cfg["border_rm"], cfg["max_matches"], mask0=mask0, mask1=mask1)
    return {"model": model, "conf": conf, "best": best, "c0": c0[0],
            "c1": c1[0], "f0": f0[0], "f1": f1[0], "hw0": hw0, "hw1": hw1,
            "n": int(i_r.numel()), "v_sorted": v_r, "k": cfg["max_matches"],
            "i": i_r, "j": j_r,
            "ok0": border_ok(hw0, cfg["border_rm"], mask0),
            "ok1": border_ok(hw1, cfg["border_rm"], mask1)}
