"""The pair generator is deterministic by seed and makes padded pairs
with exact geometry."""
import torch

from bench_port.data.pairs import make_pairs

BIG = 2 ** 31 + 12345    # seeds larger than 32 signed bits hold


def test_pairs_are_deterministic_by_seed():
    dev = torch.device("cpu")
    views, pad = [[48, 64, 64, 48]], [64, 64]
    a = make_pairs(BIG, 2, views, pad, dev)
    b = make_pairs(BIG, 2, views, pad, dev)
    c = make_pairs(BIG + 1, 2, views, pad, dev)
    for f in ("image0", "image1", "depth0", "T_0to1", "K1", "mask0"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.image0, c.image0)


def test_pairs_are_padded_with_masks_and_exact_geometry():
    P = make_pairs(3, 2, [[48, 64, 64, 48]], [64, 64], torch.device("cpu"))
    assert P.image0.dtype == torch.uint8 and P.image0.shape == (2, 64, 64)
    assert P.mask0[0, :6, :8].all() and not P.mask0[0, 6:].any()
    assert P.mask1[0, :8, :6].all() and not P.mask1[0, :, 6:].any()
    assert (P.depth0[0, 48:] == 0).all() and (P.depth0[0, :48] > 0).all()
    eye = P.T_0to1[0] @ P.T_1to0[0]
    assert torch.allclose(eye, torch.eye(4), atol=1e-5)
