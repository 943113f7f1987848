"""The LoFTR-OT benchmark reference (``bench_port/reference/
loftr_ot_plain.py``) against the port, and the OT cell's comparison.

The reference's published ``log_optimal_transport`` equals the port's two
plain Sinkhorn paths (``ops/kernels/sinkhorn.sinkhorn_plain``, the closed
dustbin form, and ``ops/matching.sinkhorn_conf``); a whole ``outdoor_ot``
forward of the port at the published widths follows it in float32; the
cell's generator passes its own limits in bf16 at a small size, and fails
them with a Sinkhorn iteration dropped or the dustbin left out.  A
``bin_score`` off by 0.5 is no fault the function shows: the dustbin's
potential absorbs the score, so the reference's own confidences move by
under 1e-5.
"""
import copy
import math

import numpy as np
import pytest
import torch

from bench_port import control_ot, core
from bench_port.data.pairs import make_pairs
from bench_port.generators import offline_ot
from bench_port.reference.loftr_ot_plain import (BIN_SCORE, OTConf,
                                                 PlainOT, ref_pair_ot)
from bench_port.weights import make_state
from loftr_tpu_torch.ops.kernels.dual_softmax import NEG
from loftr_tpu_torch.ops.kernels.sinkhorn import sinkhorn_plain
from loftr_tpu_torch.ops.matching import sinkhorn_conf

CELL = "outdoor_ot.match_ot_b4"
SEED = 2 ** 31 + 21
# a small padded pair: 20 x 20 coarse cells, 15 x 20 and 20 x 15 valid (at
# 96 px the dustbin takes so little mass that leaving it out moves the
# confidences by no more than bf16 does)
SMALL = dict(batch=1, pairs=2, views=[[120, 160, 160, 120]], pad=[160, 160],
             warmup_batches=0, check_batches=1, in_flight=1)


def _features(L, S, masked, seed=0):
    """Features with planted matches (rows of f0 copied, with noise, into
    f1) at the contrast of the cell's seeded weights; masks [L], [S] of a
    7 x 8 grid's left 6 columns and an 8 x 8 grid's top 6 rows."""
    g = torch.Generator().manual_seed(seed)
    C = 256
    f0 = torch.randn(L, C, generator=g) * 4.0
    f1 = torch.randn(S, C, generator=g) * 4.0
    k = min(L, S) // 2
    f1[:k] = f0[:k] + 2.0 * torch.randn(k, C, generator=g)
    m0 = m1 = None
    if masked:
        m0 = (torch.arange(L) % 8 < 6)
        m1 = (torch.arange(S) < 6 * 8)
    return f0, f1, m0, m1


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_reference_sinkhorn_equals_the_port_plain_paths(masked):
    L, S = 56, 64
    f0, f1, m0, m1 = _features(L, S, masked)
    alpha = torch.tensor(1.0)
    ref = OTConf(f0, f1, m0, m1, alpha, 3).conf
    bm0 = None if m0 is None else m0[None]
    bm1 = None if m1 is None else m1[None]
    out = sinkhorn_plain(f0[None], f1[None], alpha, 3, bm0, bm1,
                         with_conf=True)
    conf_matching, _ = sinkhorn_conf(f0[None], f1[None], alpha, 3, bm0, bm1)
    live = ref > 1e-30
    assert live.sum() > L
    for conf in (out[5][0], conf_matching[0]):
        rel = ((conf - ref).abs() / ref.clamp_min(1e-30))[live]
        assert float(rel.max()) < 1e-4
        assert torch.equal(conf.argmax(dim=1), ref.argmax(dim=1))
        assert torch.equal(conf.argmax(dim=0), ref.argmax(dim=0))
    # the kernel's outputs: each live row's best value and column (a
    # masked row's confidences are all 0)
    row = ref.amax(dim=1)
    live = row > 1e-30
    assert torch.equal(out[1][0].long()[live], ref.argmax(dim=1)[live])
    rel = (out[0][0] - row).abs()[live] / row[live]
    assert float(rel.max()) < 1e-4


def _small_cell(dtype=None):
    cell = copy.deepcopy(core.load_cell(CELL))
    cell.mix.update(SMALL)
    if dtype:
        cell.config["dtype"] = dtype
    return cell


class _Shifted(offline_ot.OfflineOT):
    """The port's matcher with ``bin_score`` off by 0.5."""

    @property
    def model(self):
        return self._model

    @model.setter
    def model(self, value):
        offline_ot.OfflineOT.model.fset(self, value)
        with torch.no_grad():
            self._model.coarse_matching.bin_score.add_(0.5)

    @model.deleter
    def model(self):
        del self._model


def _drive(cell, cls=offline_ot.OfflineOT, iters=None, judge=None):
    """Set-up, one batch of the window (no clock: the batch is always
    done) and the check (or ``judge`` of the generator), on the CPU."""
    torch.set_num_threads(2)
    drv = cls(cell, SEED, torch.device("cpu"))
    if iters is not None:
        drv.program_inference["skh_iters"] = iters
    drv.setup()
    drv.done = drv._run(None, 1)
    drv.free()
    got = drv.check() if judge is None else judge(drv)
    return got, [core.Check(k, float(got[k]), v)
                 for k, v in cell.limits.items()]


def test_outdoor_ot_forward_follows_the_reference_in_float32():
    """The port's whole forward (folded, padded weights; kernel E's plain
    version) against the reference from the unfolded weights."""
    from loftr_tpu_torch.structs import MatchInput
    cell = _small_cell("float32")
    dev = torch.device("cpu")
    torch.set_num_threads(2)
    drv = offline_ot.OfflineOT(cell, SEED, dev)
    drv.setup()
    P = drv.pairs
    with torch.inference_mode():
        out = drv.model(MatchInput(
            image0=P.image0[:1, ..., None].float() / 255.0,
            image1=P.image1[:1, ..., None].float() / 255.0,
            mask0=P.mask0[:1], mask1=P.mask1[:1]))
    torch.backends.cuda.matmul.allow_tf32 = False
    model = PlainOT(drv.state, cell.config["widths"])
    ref = ref_pair_ot(model, P.image0[0].float() / 255.0,
                      P.image1[0].float() / 255.0, P.mask0[0], P.mask1[0],
                      cell.config["inference"])
    v = out.valid[0]
    i, j = out.coarse.i_ids[0][v].long(), out.coarse.j_ids[0][v].long()
    assert ref["n"] > 4
    # the same matches (by row: the order by confidence may swap ties)
    o, r = torch.argsort(i), torch.argsort(ref["i"])
    assert torch.equal(i[o], ref["i"][r]) and torch.equal(j[o], ref["j"][r])
    mconf = out.coarse.mconf[0][v][o]
    want = ref["v_sorted"][r]
    assert float(((mconf - want).abs() / want).max()) < 1e-3
    e = model.fine(ref["c0"], ref["c1"], ref["f0"], ref["f1"], i, j,
                   ref["hw0"], ref["hw1"])
    wc = ref["hw1"][1]
    k1 = torch.stack([j % wc, j // wc], -1).float() * 8 + e[:, :2] * 4
    assert float((out.mkpts1_f[0][v] - k1).norm(dim=-1).max()) < 1e-3


def _no_dustbin(feat0, feat1, bin_score, iters=3, mask0=None, mask1=None,
                prefilter=False):
    """Kernel E's outputs from a Sinkhorn without the dustbin row and
    column (every marginal -log(L + S)): a planted fault."""
    B, L, C = feat0.shape
    S = feat1.shape[1]
    sim = feat0.float() @ feat1.float().transpose(1, 2) / C
    if mask0 is not None:
        pair = mask0.bool()[:, :, None] & mask1.bool()[:, None, :]
        sim = torch.where(pair, sim, torch.full_like(sim, NEG))
    norm = -math.log(L + S)
    u = sim.new_zeros((B, L))
    v = sim.new_zeros((B, S))
    for _ in range(iters):
        u = norm - torch.logsumexp(sim + v[:, None, :], dim=2)
        v = norm - torch.logsumexp(sim + u[:, :, None], dim=1)
    conf = torch.exp(sim + u[:, :, None] + v[:, None, :] - norm)
    flags = (torch.zeros((B, L), dtype=torch.bool),
             torch.zeros((B, S), dtype=torch.bool))
    return (conf.amax(dim=2), conf.argmax(dim=2).to(torch.int32),
            conf.amax(dim=1), *flags)


def test_the_cells_check_passes_a_sound_bf16_run():
    got, checks = _drive(_small_cell())
    assert got["matches"] > 4
    assert all(c.ok for c in checks), [(c.name, c.value, c.limit)
                                       for c in checks]


def _shift_coarse(monkeypatch):
    import loftr_tpu_torch.models.matcher as matcher
    real = matcher.M.topk_matches

    def moved(cand, k):
        m = real(cand, k)
        return m.__class__(i_ids=m.i_ids, j_ids=m.j_ids + 1, mconf=m.mconf,
                           mask=m.mask, gt_mask=m.gt_mask)
    monkeypatch.setattr(matcher.M, "topk_matches", moved)


@pytest.mark.parametrize("fault", ["iters_2", "no_dustbin",
                                   "coarse_match_altered",
                                   "random_1pct"])
def test_a_planted_matcher_fault_fails_a_number(monkeypatch, fault):
    cell = _small_cell()
    if fault in control_ot.MOVES:
        # a share of the port's matches moved to a random legal cell, their
        # keypoints with them: only ``odd`` can see it
        got, checks = _drive(cell, judge=lambda d: control_ot.judge_moved(
            d)["moved"][fault])
        failed = {c.name for c in checks if not c.ok}
        assert failed == {"odd"}, [(c.name, c.value, c.limit)
                                   for c in checks]
    elif fault == "no_dustbin":
        import loftr_tpu_torch.ops.kernels.sinkhorn as KE
        monkeypatch.setattr(KE, "fused_sinkhorn_match", _no_dustbin)
        got, checks = _drive(cell)
    elif fault == "coarse_match_altered":
        _shift_coarse(monkeypatch)
        got, checks = _drive(cell)
    else:
        got, checks = _drive(cell, iters=2)
    assert got["matches"] > 4
    assert not all(c.ok for c in checks), [(c.name, c.value, c.limit)
                                           for c in checks]


def test_a_bin_score_shift_leaves_the_function():
    """``bin_score`` + 0.5 in the port changes no compared number beyond
    the sound run's, and moves the float32 reference's own confidence at
    its matches by under 1e-5: the dustbin potentials absorb it."""
    cell = _small_cell()
    sound, _ = _drive(cell)
    shifted, _ = _drive(cell, cls=_Shifted)
    assert abs(shifted["mconf"] - sound["mconf"]) < 1e-3
    dev = torch.device("cpu")
    state = offline_ot.ot_state(make_state(cell.config["widths"], SEED, dev),
                                cell.config)
    P = make_pairs(SEED, 1, SMALL["views"], SMALL["pad"], dev)
    args = (P.image0[0].float() / 255.0, P.image1[0].float() / 255.0,
            P.mask0[0], P.mask1[0], cell.config["inference"])
    a = ref_pair_ot(PlainOT(state, cell.config["widths"]), *args)
    shifted = dict(state)
    shifted[BIN_SCORE] = state[BIN_SCORE] + 0.5
    b = ref_pair_ot(PlainOT(shifted, cell.config["widths"]), *args)
    i, j = a["i"], a["j"]
    rel = ((b["conf"].conf[i, j] - a["conf"].conf[i, j]).abs()
           / a["conf"].conf[i, j])
    assert a["n"] > 4 and float(rel.max()) < 1e-5
    assert np.isfinite(float(rel.max()))
