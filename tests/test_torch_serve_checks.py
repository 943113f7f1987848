"""PyTorch port: the checks that ``chip_smoke.py`` phase 12 holds the
service's responses to, on the CPU.  ``hold_responses`` with a measured
confidence move excuses only the match flips that move can cause, and
``conv_batch_witness`` tells a convolution whose bits depend on the batch
size (the card's cuDNN at 840 px) from any other batch dependence of the
backbone."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import loftr_tpu_torch.models.backbone as bbm
from loftr_tpu_torch import LoFTR, get_config
from loftr_tpu_torch.utils.weights import init_weights

from test_torch_serve import SMALL


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _response(conf, wc):
    """The mutual nearest neighbours of ``conf`` as a service response
    (coarse points at stride 8)."""
    r, c = conf.argmax(1), conf.argmax(0)
    ii = [i for i in range(conf.shape[0]) if int(c[r[i]]) == i]
    pts = lambda idx: np.array([[k % wc * 8, k // wc * 8] for k in idx],
                               np.float64).reshape(-1, 2)
    return {"mkpts0": pts(ii), "mkpts1": pts([int(r[i]) for i in ii]),
            "mconf": np.array([float(conf[i, r[i]]) for i in ii])}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_measured_move_excuses_only_the_flips_it_can_cause(seed):
    g = torch.Generator().manual_seed(seed)
    # half the rows hold one clear peak (top-2 gaps near 0.9), half are
    # flat (gaps near 0.002): a move of 0.15 flips only flat rows
    conf = torch.rand(48, 48, generator=g) * 0.1
    peaks = torch.randperm(48, generator=g)[:24]
    conf[peaks, torch.randperm(48, generator=g)[:24]] = 1.0
    moved = conf + (torch.rand(48, 48, generator=g) - 0.5) * 0.3
    want, got = _response(conf, 6), _response(moved, 6)
    d = (moved - conf).abs()
    move = (d.amax(1).numpy(), d.amax(0).numpy())
    strict = cs.hold_responses([got], want, want, conf, 6)
    assert strict[0] and strict[3] == 0 and strict[4] == []
    odd, _, _, excused, covered = cs.hold_responses(
        [got], want, want, conf, 6, [move])
    assert odd == [] and excused == len(strict[0])
    assert 0 < covered[0] <= 1
    # a move stated a thousand times too small leaves flips unexplained
    small = cs.hold_responses([got], want, want, conf, 6,
                              [(move[0] / 1000, move[1] / 1000)])
    assert small[0]
    # and a response that moves past its own measure (peaks too) is caught
    far = _response(conf + (torch.rand(48, 48, generator=g) - 0.5) * 4, 6)
    assert cs.hold_responses([far], want, want, conf, 6, [move])[0]


def _model():
    return init_weights(LoFTR(get_config("indoor_ds", SMALL).loftr), 0).eval()


def _pair():
    r = np.random.RandomState(3)
    return ((r.rand(32, 48) * 255).astype(np.uint8),
            (r.rand(32, 48) * 255).astype(np.uint8))


def test_conv_batch_witness_chunked_forward_gives_b1_bits():
    """The backbone's only batch dependence is its convolutions' (this
    CPU's 7x7 stem convolution among them at some shapes): with each at
    the B=1 call's batch, the batch-2 forward gives the B=1 bits."""
    w = cs.conv_batch_witness(_model(), *_pair(), 2, torch.device("cpu"))
    assert w["conv_calls"] > 0 and w["same_bits_convs_at_b1_batch"]
    assert w["same_bits"] or w["batch_variant_convs"]


def test_conv_batch_witness_names_a_batch_dependent_conv(monkeypatch):
    """A convolution whose result depends on its batch size (as cuDNN's
    algorithm choice makes it): the witness lists it, and with every
    convolution at the B=1 call's batch the bits come back."""
    orig = bbm.apply_conv
    monkeypatch.setattr(bbm, "apply_conv", lambda m, x: orig(m, x) + (
        1e-3 if x.shape[0] > 2 and m.kernel_size[0] == 3 else 0.0))
    w = cs.conv_batch_witness(_model(), *_pair(), 2, torch.device("cpu"))
    assert sum(c["k"] == 3 for c in w["batch_variant_convs"]) == sum(
        m.kernel_size[0] == 3 for m in _model().backbone.modules()
        if isinstance(m, torch.nn.Conv2d))
    assert not w["same_bits"] and w["same_bits_convs_at_b1_batch"]


def test_conv_batch_witness_catches_other_batch_dependence(monkeypatch):
    """A batch dependence outside the convolutions is not excused: the
    chunked forward keeps it, so its bits stay off B=1's."""
    orig = bbm.apply_bn
    monkeypatch.setattr(bbm, "apply_bn", lambda bn, x: orig(bn, x) + (
        1e-3 if x.shape[0] > 2 else 0.0))
    w = cs.conv_batch_witness(_model(), *_pair(), 2, torch.device("cpu"))
    assert not w["same_bits"] and not w["same_bits_convs_at_b1_batch"]
