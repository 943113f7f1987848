"""On the card: the FPN merge kernel (``upsample2x_add``) against its plain
version, and the backbone's two merge launches at inference.  Skips without
CUDA.  This file imports no JAX; on the card run it with

    python3 -m pytest --noconftest -o addopts="" tests/test_torch_upsample_card.py
"""
import numpy as np
import pytest
import torch

from loftr_tpu_torch.models import backbone as tb
from loftr_tpu_torch.ops.kernels import upsample as ku
from loftr_tpu_torch.utils.weights import init_weights

CL = torch.channels_last


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); none here")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 15, 20), (1, 256, 21, 21),
                                   (3, 196, 15, 1), (2, 13, 1, 9)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_merge_kernel_equals_plain(shape, dtype):
    """bfloat16 bit for bit, float32 to two-term float sums, against the
    plain version on the CPU copy; the sum is channels-last and counted."""
    dev = _card()
    b, c, h, w = shape
    r = np.random.RandomState(sum(shape))
    coarse = torch.from_numpy(r.randn(*shape).astype(np.float32)).to(dtype)
    lateral = torch.from_numpy(
        r.randn(b, c, 2 * h, 2 * w).astype(np.float32)).to(dtype)
    want = ku.upsample2x_add_plain(lateral, coarse)
    n0 = ku.upsample2x_add.launches
    got = ku.upsample2x_add(lateral.to(dev, memory_format=CL),
                            coarse.to(dev, memory_format=CL))
    assert ku.upsample2x_add.launches == n0 + 1
    assert got.is_contiguous(memory_format=CL) and got.dtype == dtype
    got = got.cpu()
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="channels-last"):
        ku.upsample2x_add(lateral.to(dev), coarse.to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["batch", "group"])
def test_backbone_launches_two_merges_at_inference(norm):
    """An eval forward without a graph launches the kernel at both merges
    (a ``group`` backbone's NCHW maps too) and gives the maps of the plain
    merge on the CPU copy; a training step launches none."""
    dev = _card()
    net = init_weights(tb.ResNetFPN_8_2(16, (16, 24, 32), norm=norm),
                       2).to(dev).eval()
    x = torch.from_numpy(np.random.RandomState(3).rand(
        2, 64, 96, 1).astype(np.float32)).to(dev)
    n0 = ku.upsample2x_add.launches
    with torch.no_grad():
        got = net(x, torch.bfloat16)
        assert ku.upsample2x_add.launches == n0 + 2
        merge = tb._merge
        try:
            tb._merge = lambda conv, x, c, train: ku.upsample2x_add_plain(
                tb.apply_conv(conv, x).cpu(), c.cpu()).to(
                dev, memory_format=CL)
            want = net(x, torch.bfloat16)
        finally:
            tb._merge = merge
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    n0 = ku.upsample2x_add.launches
    net.train()(x)[0].float().sum().backward()
    assert ku.upsample2x_add.launches == n0
    assert net.conv1.weight.grad is not None
