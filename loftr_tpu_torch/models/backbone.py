"""ResNet-FPN backbone, the (8, 2) and (16, 4) variants.

Same topology and parameter names as the reference's ``resnet_fpn.py`` (and
``loftr_tpu.models.backbone``): stem conv7x7/s2, three (four) stages of two
BasicBlocks (strides 1/2/2(/2)), a top-down FPN with 1x1 laterals, x2
align-corners upsampling and 3x3 fusion blocks.  Outputs the coarse (1/8,
``block_dims[2]``) and fine (1/2, ``block_dims[0]``) maps, or for (16, 4)
the coarse (1/16, ``block_dims[3]``) and fine (1/4, ``block_dims[1]``)
maps.

``norm`` is the JAX package's ``Norm``: ``batch`` (below), ``group``
(GroupNorm with 8 groups, in float32, cast back) or ``none``, the folded
inference mode of ``utils/folding.py``: no norm modules, and the convs
that were paired with a BatchNorm carry its affine as a bias.  A ``none``
backbone refuses ``train()``.

The public layout is NHWC, as in the JAX package; the body runs NCHW so the
convolutions go to cuDNN.  Parameters stay float32 and are cast to the
activation dtype at each use.  In ``eval()`` BatchNorm is a per-channel
affine whose coefficients are computed in float32 and applied in the
activation dtype (``loftr_tpu.models.backbone._BnEvalAffine``).  In
``train()`` it normalises with the statistics of the batch it is given (both
images of every pair, packed), computed in float32, and updates the running
statistics in place.

The FPN's top-down merges (``lateral + x2 upsample of the coarser map``)
go through ``_merge``: an inference forward takes the upsample-add kernel
(``ops/kernels/upsample.py::upsample2x_add``, on channels-last maps; on
the CPU its plain version, the same expression), training and any map
that needs a gradient the differentiable two-matmul form.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from loftr_tpu_torch.ops.interpolate import upsample2x_align_corners
from loftr_tpu_torch.ops.kernels import upsample as _kg
from loftr_tpu_torch.parallel import comm
from loftr_tpu_torch.utils.derived import derived


def conv(in_ch: int, out_ch: int, kernel: int, stride: int = 1,
         bias: bool = False) -> nn.Conv2d:
    """Conv with symmetric padding (k-1)//2; bias-free unless it carries a
    folded BatchNorm (``norm="none"``)."""
    return nn.Conv2d(in_ch, out_ch, kernel, stride, padding=(kernel - 1) // 2,
                     bias=bias)


def apply_conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    if m.bias is None:
        w = derived(m, x.dtype, [m.weight], lambda: m.weight.to(x.dtype))
        return F.conv2d(x, w, None, m.stride, m.padding)
    w, b = derived(m, x.dtype, [m.weight, m.bias],
                   lambda: (m.weight.to(x.dtype), m.bias.to(x.dtype)))
    return F.conv2d(x, w, b, m.stride, m.padding)


def _merge(outconv: nn.Conv2d, x: torch.Tensor, coarse: torch.Tensor,
           train: bool) -> torch.Tensor:
    """The FPN's top-down merge: the lateral ``apply_conv(outconv, x)`` +
    x2 align-corners upsample of coarse.  Training, or a map that needs a
    gradient, takes the differentiable two-matmul form; an inference
    forward takes the upsample-add kernel.  On the card its operands are
    made channels-last first: a no-op for the maps of a BatchNorm or
    folded backbone (the stem's one-channel view keeps every convolution
    channels-last), a copy for a ``group`` one (CUDA's GroupNorm returns
    NCHW).  The lateral is formed here, so it is freed before the fusion
    block runs."""
    lateral = apply_conv(outconv, x)
    if train or lateral.requires_grad or coarse.requires_grad:
        return lateral + upsample2x_align_corners(coarse)
    if lateral.is_cuda:
        cl = torch.channels_last
        lateral = lateral.contiguous(memory_format=cl)
        coarse = coarse.contiguous(memory_format=cl)
    return _kg.upsample2x_add(lateral, coarse)


def make_norm(kind: str, ch: int) -> nn.Module:
    """The backbone's ``Norm`` (``loftr_tpu.models.backbone.Norm``):
    BatchNorm with torch's eps and momentum, GroupNorm with 8 groups and
    eps 1e-5, or the identity of the folded mode ``none`` (the paired conv
    then carries the bias)."""
    if kind == "batch":
        return nn.BatchNorm2d(ch)
    if kind == "group":
        return nn.GroupNorm(8, ch, eps=1e-5)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"norm {kind!r}")


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
    ``torch.nn.functional.batch_norm`` would write the unbiased one (and so
    would ``nn.SyncBatchNorm``).

    Inside ``parallel.comm.data_parallel`` the statistics are those of the
    global batch, as under JAX's data-sharded mesh: each rank's E[x] and
    E[x^2], weighted by its share of the global count (1 / ranks: every
    rank holds as many rows), are summed by ``comm.batch_sum`` (its
    backward sums the gradients).  A group of one rank weighs by exactly 1
    and gives the statistics of the plain step bit for bit."""
    x32 = x.float()
    mean = x32.mean(dim=(0, 2, 3))
    sq = (x32 * x32).mean(dim=(0, 2, 3))
    dg = comm.data_group()
    if dg is not None:
        stats = comm.batch_sum(torch.stack([mean, sq]) / dg.size)
        mean, sq = stats[0], stats[1]
    # the variance as flax forms it: E[x^2] - E[x]^2, clamped at 0
    var = (sq - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.lerp_(mean.detach(), bn.momentum)
        bn.running_var.lerp_(var.detach(), bn.momentum)
        bn.num_batches_tracked += 1
    inv = bn.weight * torch.rsqrt(var + bn.eps)
    y = (x32 - mean[None, :, None, None]) * inv[None, :, None, None] \
        + bn.bias[None, :, None, None]
    return y.to(x.dtype)


def apply_bn(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The norm in x's dtype.  BatchNorm: batch statistics when
    ``bn.training``, else the running statistics folded into a float32
    affine.  GroupNorm: computed in float32 and cast back, in both modes.
    Identity (folded): x."""
    if isinstance(bn, nn.Identity):
        return x
    if isinstance(bn, nn.GroupNorm):
        return F.group_norm(x.float(), bn.num_groups, bn.weight, bn.bias,
                            bn.eps).to(x.dtype)
    if bn.training:
        return _bn_train(bn, x)
    inv, shift = derived(
        bn, x.dtype, [bn.weight, bn.bias, bn.running_mean, bn.running_var],
        lambda: _bn_affine(bn, x.dtype))
    return x * inv + shift


class BasicBlock(nn.Module):
    """Two 3x3 convs + norm with identity/projection shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 norm: str = "batch"):
        super().__init__()
        fb = norm == "none"
        self.conv1 = conv(in_planes, planes, 3, stride, fb)
        self.conv2 = conv(planes, planes, 3, 1, fb)
        self.bn1 = make_norm(norm, planes)
        self.bn2 = make_norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(
                conv(in_planes, planes, 1, stride, fb),
                make_norm(norm, planes))

    def forward(self, x):
        y = F.relu(apply_bn(self.bn1, apply_conv(self.conv1, x)))
        y = apply_bn(self.bn2, apply_conv(self.conv2, y))
        if self.downsample is not None:
            x = apply_bn(self.downsample[1], apply_conv(self.downsample[0], x))
        return F.relu(x + y)


def fusion_block(mid: int, out: int, norm: str = "batch") -> nn.Sequential:
    """3x3 -> norm -> LeakyReLU -> 3x3 (the reference's
    ``layerN_outconv2``)."""
    return nn.Sequential(conv(mid, mid, 3, 1, norm == "none"),
                         make_norm(norm, mid), nn.LeakyReLU(0.01),
                         conv(mid, out, 3))


def apply_fusion(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    x = F.leaky_relu(apply_bn(seq[1], apply_conv(seq[0], x)), 0.01)
    return apply_conv(seq[3], x)


def _stage(in_planes: int, planes: int, stride: int, norm: str):
    return nn.Sequential(BasicBlock(in_planes, planes, stride, norm),
                         BasicBlock(planes, planes, 1, norm))


class _ResNetFPN(nn.Module):
    """Shared stem, stages and input handling of the two variants."""

    def __init__(self, initial_dim: int, block_dims: Sequence[int],
                 norm: str):
        super().__init__()
        self.norm = norm
        self.conv1 = conv(1, initial_dim, 7, 2, norm == "none")
        self.bn1 = make_norm(norm, initial_dim)

    def train(self, mode: bool = True):
        if mode and self.norm == "none":
            raise ValueError("backbone norm 'none' (folded BatchNorm) is "
                             "inference only: train the 'batch' model and "
                             "fold it afterwards")
        return super().train(mode)

    def stem(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(dtype)
        if torch.is_grad_enabled():
            # under autograd, a copy with standard NCHW strides.  The
            # permuted view of a one-channel image has the strides of a
            # channels-last tensor: the CPU convolution's backward corrupts
            # memory on it (PyTorch 2.13), and on CUDA it sends the whole
            # training backbone down cuDNN's channels-last path, which
            # PERF.md measures slower.  Inference keeps the view.
            x = x.clone(memory_format=torch.contiguous_format)
        return F.relu(apply_bn(self.bn1, apply_conv(self.conv1, x)))


class ResNetFPN_8_2(_ResNetFPN):
    """Outputs (coarse 1/8 @ block_dims[2], fine 1/2 @ block_dims[0])."""

    def __init__(self, initial_dim: int = 128,
                 block_dims: Sequence[int] = (128, 196, 256),
                 norm: str = "batch"):
        super().__init__(initial_dim, block_dims, norm)
        d = tuple(block_dims)
        self.layer1 = _stage(initial_dim, d[0], 1, norm)
        self.layer2 = _stage(d[0], d[1], 2, norm)
        self.layer3 = _stage(d[1], d[2], 2, norm)
        self.layer3_outconv = conv(d[2], d[2], 1)
        self.layer2_outconv = conv(d[1], d[2], 1)
        self.layer2_outconv2 = fusion_block(d[2], d[1], norm)
        self.layer1_outconv = conv(d[0], d[1], 1)
        self.layer1_outconv2 = fusion_block(d[1], d[0], norm)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32):
        """x: [B, H, W, 1] -> (coarse [B, H/8, W/8, C2], fine [B, H/2, W/2, C0])."""
        x0 = self.stem(x, dtype)
        x1 = self.layer1(x0)                                  # 1/2
        x2 = self.layer2(x1)                                  # 1/4
        x3 = self.layer3(x2)                                  # 1/8
        x3_out = apply_conv(self.layer3_outconv, x3)
        x2_out = apply_fusion(self.layer2_outconv2, _merge(
            self.layer2_outconv, x2, x3_out, self.training))
        x1_out = apply_fusion(self.layer1_outconv2, _merge(
            self.layer1_outconv, x1, x2_out, self.training))
        return x3_out.permute(0, 2, 3, 1), x1_out.permute(0, 2, 3, 1)


class ResNetFPN_16_4(_ResNetFPN):
    """Outputs (coarse 1/16 @ block_dims[3], fine 1/4 @ block_dims[1])
    (``loftr_tpu.models.backbone.ResNetFPN_16_4``; the reference's
    resnet_fpn.py:121-199)."""

    def __init__(self, initial_dim: int = 128,
                 block_dims: Sequence[int] = (128, 196, 256, 512),
                 norm: str = "batch"):
        super().__init__(initial_dim, block_dims, norm)
        d = tuple(block_dims)
        self.layer1 = _stage(initial_dim, d[0], 1, norm)
        self.layer2 = _stage(d[0], d[1], 2, norm)
        self.layer3 = _stage(d[1], d[2], 2, norm)
        self.layer4 = _stage(d[2], d[3], 2, norm)
        self.layer4_outconv = conv(d[3], d[3], 1)
        self.layer3_outconv = conv(d[2], d[3], 1)
        self.layer3_outconv2 = fusion_block(d[3], d[2], norm)
        self.layer2_outconv = conv(d[1], d[2], 1)
        self.layer2_outconv2 = fusion_block(d[2], d[1], norm)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32):
        """x: [B, H, W, 1] -> (coarse [B, H/16, W/16, C3],
        fine [B, H/4, W/4, C1])."""
        x0 = self.stem(x, dtype)
        x1 = self.layer1(x0)                                  # 1/2
        x2 = self.layer2(x1)                                  # 1/4
        x3 = self.layer3(x2)                                  # 1/8
        x4 = self.layer4(x3)                                  # 1/16
        x4_out = apply_conv(self.layer4_outconv, x4)
        x3_out = apply_fusion(self.layer3_outconv2, _merge(
            self.layer3_outconv, x3, x4_out, self.training))
        x2_out = apply_fusion(self.layer2_outconv2, _merge(
            self.layer2_outconv, x2, x3_out, self.training))
        return x4_out.permute(0, 2, 3, 1), x2_out.permute(0, 2, 3, 1)


def build_backbone(resolution: tuple, initial_dim: int,
                   block_dims: Sequence[int], norm: str = "batch"):
    """Dispatch on the resolution, as ``loftr_tpu.models.backbone``."""
    if norm not in ("batch", "group", "none"):
        raise ValueError(f"norm {norm!r}")
    if tuple(resolution) == (8, 2):
        return ResNetFPN_8_2(initial_dim, block_dims, norm)
    if tuple(resolution) == (16, 4):
        return ResNetFPN_16_4(initial_dim, block_dims, norm)
    raise ValueError(f"unsupported resolution {resolution}")
