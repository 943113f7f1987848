"""ResNet-FPN backbone, (8, 2) variant.

Same topology and parameter names as the reference's ``resnet_fpn.py`` (and
``loftr_tpu.models.backbone``): stem conv7x7/s2, three stages of two
BasicBlocks (strides 1/2/2), a top-down FPN with 1x1 laterals, x2
align-corners upsampling and 3x3 fusion blocks.  Outputs the coarse (1/8,
``block_dims[2]``) and fine (1/2, ``block_dims[0]``) maps.

The public layout is NHWC, as in the JAX package; the body runs NCHW so the
convolutions go to cuDNN.  Parameters stay float32 and are cast to the
activation dtype at each use.  In ``eval()`` BatchNorm is a per-channel
affine whose coefficients are computed in float32 and applied in the
activation dtype (``loftr_tpu.models.backbone._BnEvalAffine``).  In
``train()`` it normalises with the statistics of the batch it is given (both
images of every pair, packed), computed in float32, and updates the running
statistics in place.

``_USE_PALLAS_UPSAMPLE`` (a module switch, default off, as in the JAX
package) sends the two x2 upsamples of an inference forward through the
upsample kernel module instead of the two-matmul form.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from loftr_tpu_torch.ops.interpolate import upsample2x_align_corners
from loftr_tpu_torch.utils.derived import derived


_USE_PALLAS_UPSAMPLE = False


def _upsample(x: torch.Tensor, train: bool) -> torch.Tensor:
    """x2 align-corners upsample: the kernel module at inference when the
    module switch is on, else the differentiable two-matmul form."""
    if _USE_PALLAS_UPSAMPLE and not train and not x.requires_grad:
        from loftr_tpu_torch.ops.kernels.upsample import upsample2x
        return upsample2x(x)
    return upsample2x_align_corners(x)


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    """Bias-free conv with symmetric padding (k-1)//2."""
    return nn.Conv2d(in_ch, out_ch, kernel, stride, padding=(kernel - 1) // 2,
                     bias=False)


def apply_conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    w = derived(m, x.dtype, [m.weight], lambda: m.weight.to(x.dtype))
    return F.conv2d(x, w, None, m.stride, m.padding)


def _bn_affine(bn: nn.BatchNorm2d, dtype: torch.dtype):
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shift = bn.bias - bn.running_mean * inv
    return (inv.to(dtype)[None, :, None, None],
            shift.to(dtype)[None, :, None, None])


def _bn_train(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Training BatchNorm: float32 batch statistics over (N, H, W), running
    statistics updated in place with ``bn.momentum``.

    The running variance takes the *biased* batch variance, as flax's
    ``nn.BatchNorm`` does in the JAX package this port is held against;
    ``torch.nn.functional.batch_norm`` would write the unbiased one."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    # the variance as flax forms it: E[x^2] - E[x]^2, clamped at 0
    var = ((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.lerp_(mean.detach(), bn.momentum)
        bn.running_var.lerp_(var.detach(), bn.momentum)
        bn.num_batches_tracked += 1
    inv = bn.weight * torch.rsqrt(var + bn.eps)
    y = (x32 - mean[None, :, None, None]) * inv[None, :, None, None] \
        + bn.bias[None, :, None, None]
    return y.to(x.dtype)


def apply_bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in x's dtype: batch statistics when ``bn.training``, else
    the running statistics folded into a float32 affine."""
    if bn.training:
        return _bn_train(bn, x)
    inv, shift = derived(
        bn, x.dtype, [bn.weight, bn.bias, bn.running_mean, bn.running_var],
        lambda: _bn_affine(bn, x.dtype))
    return x * inv + shift


class BasicBlock(nn.Module):
    """Two 3x3 convs + BN with identity/projection shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.conv2 = conv(planes, planes, 3, 1)
        self.bn1 = nn.BatchNorm2d(planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(conv(in_planes, planes, 1, stride),
                                            nn.BatchNorm2d(planes))

    def forward(self, x):
        y = F.relu(apply_bn(self.bn1, apply_conv(self.conv1, x)))
        y = apply_bn(self.bn2, apply_conv(self.conv2, y))
        if self.downsample is not None:
            x = apply_bn(self.downsample[1], apply_conv(self.downsample[0], x))
        return F.relu(x + y)


def fusion_block(mid: int, out: int) -> nn.Sequential:
    """3x3 -> BN -> LeakyReLU -> 3x3 (the reference's ``layerN_outconv2``)."""
    return nn.Sequential(conv(mid, mid, 3), nn.BatchNorm2d(mid),
                         nn.LeakyReLU(0.01), conv(mid, out, 3))


def apply_fusion(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    x = F.leaky_relu(apply_bn(seq[1], apply_conv(seq[0], x)), 0.01)
    return apply_conv(seq[3], x)


class ResNetFPN_8_2(nn.Module):
    """Outputs (coarse 1/8 @ block_dims[2], fine 1/2 @ block_dims[0])."""

    def __init__(self, initial_dim: int = 128,
                 block_dims: Sequence[int] = (128, 196, 256)):
        super().__init__()
        d = tuple(block_dims)
        self.conv1 = conv(1, initial_dim, 7, 2)
        self.bn1 = nn.BatchNorm2d(initial_dim)
        self.layer1 = nn.Sequential(BasicBlock(initial_dim, d[0], 1),
                                    BasicBlock(d[0], d[0], 1))
        self.layer2 = nn.Sequential(BasicBlock(d[0], d[1], 2),
                                    BasicBlock(d[1], d[1], 1))
        self.layer3 = nn.Sequential(BasicBlock(d[1], d[2], 2),
                                    BasicBlock(d[2], d[2], 1))
        self.layer3_outconv = conv(d[2], d[2], 1)
        self.layer2_outconv = conv(d[1], d[2], 1)
        self.layer2_outconv2 = fusion_block(d[2], d[1])
        self.layer1_outconv = conv(d[0], d[1], 1)
        self.layer1_outconv2 = fusion_block(d[1], d[0])

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32):
        """x: [B, H, W, 1] -> (coarse [B, H/8, W/8, C2], fine [B, H/2, W/2, C0])."""
        x = x.permute(0, 3, 1, 2).to(dtype)
        if torch.is_grad_enabled():
            # under autograd, a copy with standard NCHW strides.  The
            # permuted view of a one-channel image has the strides of a
            # channels-last tensor: the CPU convolution's backward corrupts
            # memory on it (PyTorch 2.13), and on CUDA it sends the whole
            # training backbone down cuDNN's channels-last path, which
            # PERF.md measures slower.  Inference keeps the view.
            x = x.clone(memory_format=torch.contiguous_format)
        x0 = F.relu(apply_bn(self.bn1, apply_conv(self.conv1, x)))
        x1 = self.layer1(x0)                                  # 1/2
        x2 = self.layer2(x1)                                  # 1/4
        x3 = self.layer3(x2)                                  # 1/8
        x3_out = apply_conv(self.layer3_outconv, x3)
        x3_up = _upsample(x3_out, self.training)
        x2_out = apply_conv(self.layer2_outconv, x2)
        x2_out = apply_fusion(self.layer2_outconv2, x2_out + x3_up)
        x2_up = _upsample(x2_out, self.training)
        x1_out = apply_conv(self.layer1_outconv, x1)
        x1_out = apply_fusion(self.layer1_outconv2, x1_out + x2_up)
        return x3_out.permute(0, 2, 3, 1), x1_out.permute(0, 2, 3, 1)


def build_backbone(resolution: tuple, initial_dim: int,
                   block_dims: Sequence[int], norm: str = "batch"):
    if tuple(resolution) != (8, 2):
        raise NotImplementedError(
            f"resolution {resolution}: only the (8, 2) backbone is ported")
    if norm != "batch":
        raise NotImplementedError(f"norm {norm!r}: only 'batch' is ported")
    return ResNetFPN_8_2(initial_dim, block_dims)
