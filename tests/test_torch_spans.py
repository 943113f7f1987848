"""PyTorch port: the stage spans (``utils/profiler.span``) of the matcher
and the trainer, on the CPU with a tiny model.

Under ``torch.profiler`` a forward records ``loftr.extract``,
``loftr.coarse``, ``loftr.match`` and ``loftr.fine`` in that order, and a
training step the six ``train.*`` spans with the matcher's inside
``train.forward``; the spans change no number.  With no profiler running a
span is one shared no-op context.
"""
import timeit

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from loftr_tpu_torch import get_config
from loftr_tpu_torch.models.matcher import LoFTR
from loftr_tpu_torch.structs import MatchInput
from loftr_tpu_torch.train.trainer import Trainer
from loftr_tpu_torch.utils import profiler as P
from loftr_tpu_torch.utils.weights import init_weights

TINY = {
    "backbone": {"initial_dim": 8, "block_dims": (8, 12, 16)},
    "coarse": {"d_model": 16, "nhead": 2, "layer_names": ("self", "cross")},
    "fine": {"d_model": 8, "nhead": 2, "layer_names": ("self", "cross")},
    "match_coarse": {"train_matches": 8, "train_pad_num_gt_min": 2,
                     "thr": 0.0},
}
MATCH = ["loftr.extract", "loftr.coarse", "loftr.match", "loftr.fine"]
TRAIN = ["train.upload", "train.supervision", "train.forward", "train.loss",
         "train.backward", "train.update"]


def _cfg():
    return get_config("indoor_ds").replaced({
        "loftr": TINY, "trainer": {"scheduler_interval": "step",
                                   "warmup_step": 10}})


def _batch(B=2, H=64, W=64, seed=0):
    rng = np.random.RandomState(seed)
    K = np.array([[[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]] * B,
                 np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    arrays = dict(image0=rng.rand(B, H, W, 1), image1=rng.rand(B, H, W, 1),
                  depth0=np.full((B, H, W), 2.0), depth1=np.full((B, H, W), 2.0),
                  T_0to1=T, T_1to0=T, K0=K, K1=K)
    return MatchInput(**{k: torch.from_numpy(np.asarray(v, np.float32))
                         for k, v in arrays.items()})


def _spans(prof, prefix):
    """(name, start, end) of the host ranges named ``prefix``*, in order."""
    ev = [(e.name(), e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events()
          if e.is_user_annotation() and e.name().startswith(prefix)]
    return sorted(ev, key=lambda x: x[1])


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_forward_records_the_four_stages_in_order_and_changes_nothing():
    model = LoFTR(_cfg().loftr)
    init_weights(model, 0)
    model.eval()
    inp = _batch()
    with torch.inference_mode():
        plain = model(inp)
        traced, prof = _traced(lambda: model(inp))
    assert [n for n, _, _ in _spans(prof, "loftr.")] == MATCH
    for a, b in [(plain.mkpts0_f, traced.mkpts0_f),
                 (plain.mkpts1_f, traced.mkpts1_f),
                 (plain.coarse.mconf, traced.coarse.mconf),
                 (plain.coarse.i_ids, traced.coarse.i_ids),
                 (plain.valid, traced.valid)]:
        assert torch.equal(a, b)


def test_train_step_records_six_stages_with_the_matcher_inside_forward():
    trainer = Trainer(_cfg(), device="cpu")
    batch = _batch(seed=1)
    s_plain = trainer.init_state(seed=3)
    s_traced = trainer.init_state(seed=3)
    _, plain = trainer.train_step(s_plain, batch)
    (_, traced), prof = _traced(lambda: trainer.train_step(s_traced, batch))
    train = _spans(prof, "train.")
    assert [n for n, _, _ in train] == TRAIN
    fwd = next(s for s in train if s[0] == "train.forward")
    inner = _spans(prof, "loftr.")
    assert [n for n, _, _ in inner] == MATCH
    assert all(fwd[1] <= s and e <= fwd[2] for _, s, e in inner)
    assert sorted(plain) == sorted(traced)
    for k in plain:
        assert torch.equal(torch.as_tensor(plain[k]),
                           torch.as_tensor(traced[k])), k
    for (n, p), q in zip(s_plain.module.named_parameters(),
                         s_traced.module.parameters()):
        assert torch.equal(p, q), n


def test_without_a_profiler_a_span_is_the_shared_noop(monkeypatch):
    assert not torch._C._autograd._profiler_enabled()
    assert P.span("a") is P.span("b") is P._NO_SPAN
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    region = P.RegionProfiler(enabled=False)
    with region.profile("x"):
        pass
    assert region.profile("x") is P._NO_SPAN
    assert entered == [] and region.times == {}


def test_a_disabled_region_still_groups_its_ops_under_a_profiler():
    region = P.RegionProfiler(enabled=False)

    def work():
        with region.profile("sfm/x"):
            return torch.ones(4) + 1
    _, prof = _traced(work)
    assert [n for n, _, _ in _spans(prof, "sfm/")] == ["sfm/x"]
    assert region.times == {}


@pytest.mark.parametrize("how", ["span", "disabled_region"])
def test_a_span_costs_under_a_microsecond_without_a_profiler(how):
    enter = (P.span if how == "span"
             else P.RegionProfiler(enabled=False).profile)

    def spanned():
        with enter("loftr.extract"):
            pass

    def bare():
        pass
    # the least of many short samples: one that no other process cut into
    n, r = 500, 400
    cost = (min(timeit.repeat(spanned, number=n, repeat=r))
            - min(timeit.repeat(bare, number=n, repeat=r))) / n
    assert cost < 1e-6, f"{cost * 1e6:.3f} us a span"
