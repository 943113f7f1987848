"""PyTorch port: every kernel wrapper's device rule.  A wrapper runs its
plain version only when all of its tensors lie on the CPU and launches its
kernel only when all lie on one CUDA device; anything else (a meta tensor,
a CUDA tensor beside a CPU one) raises ``ValueError`` before a pointer
reaches a kernel.  The meta device stands in for "neither CPU nor CUDA"
here, where there is no card."""
import pytest
import torch

from loftr_tpu_torch.ops.kernels.coarse_layer import fused_coarse_layer
from loftr_tpu_torch.ops.kernels.dual_softmax import fused_dual_softmax_match
from loftr_tpu_torch.ops.kernels.fine_stage import fused_fine_stage
from loftr_tpu_torch.ops.kernels.focal_loss import fused_focal_sums
from loftr_tpu_torch.ops.kernels.sinkhorn import fused_sinkhorn_match
from loftr_tpu_torch.ops.kernels.upsample import upsample2x
from loftr_tpu_torch.ops.kernels.window_attention import \
    window_linear_attention


def _t(shape, device):
    return torch.zeros(shape, device=device)


# wrapper name -> (call taking its tensor inputs, their shapes)
WRAPPERS = {
    "coarse_layer": (lambda x, s: fused_coarse_layer(x, s, None),
                     [(1, 8, 64), (1, 8, 64)]),
    "dual_softmax": (lambda a, b: fused_dual_softmax_match(a, b),
                     [(1, 7, 256), (1, 5, 256)]),
    "fine_stage": (lambda a, b: fused_fine_stage(a, b, None, None, 8),
                   [(2, 25, 128), (2, 25, 128)]),
    "focal_loss": (lambda a, b: fused_focal_sums(a, b, None, None),
                   [(1, 7, 256), (1, 5, 256)]),
    "sinkhorn": (lambda a, b: fused_sinkhorn_match(a, b, torch.tensor(1.0)),
                 [(1, 7, 256), (1, 5, 256)]),
    "upsample": (lambda x: upsample2x(x), [(1, 4, 3, 5)]),
    "window_attention": (lambda q, k, v: window_linear_attention(q, k, v, 8),
                         [(2, 25, 128)] * 3),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_meta_inputs_raise(name):
    call, shapes = WRAPPERS[name]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        call(*[_t(s, "meta") for s in shapes])


@pytest.mark.parametrize("name", sorted(k for k in WRAPPERS
                                        if len(WRAPPERS[k][1]) > 1))
def test_mixed_devices_raise(name):
    """The first input on the CPU, the last elsewhere: no plain version on
    half the inputs, an error."""
    call, shapes = WRAPPERS[name]
    devs = ["cpu"] * (len(shapes) - 1) + ["meta"]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        call(*[_t(s, d) for s, d in zip(shapes, devs)])


# wrapper name -> call taking CPU features and one optional mask
MASKED = {
    "coarse_layer": lambda m: fused_coarse_layer(
        _t((1, 8, 64), "cpu"), _t((1, 8, 64), "cpu"), None, src_mask=m),
    "dual_softmax": lambda m: fused_dual_softmax_match(
        _t((1, 7, 256), "cpu"), _t((1, 5, 256), "cpu"), mask1=m),
    "focal_loss": lambda m: fused_focal_sums(
        _t((1, 7, 256), "cpu"), _t((1, 5, 256), "cpu"), None, None,
        mask1=m),
    "sinkhorn": lambda m: fused_sinkhorn_match(
        _t((1, 7, 256), "cpu"), _t((1, 5, 256), "cpu"), torch.tensor(1.0),
        mask1=m),
}


@pytest.mark.parametrize("name", sorted(MASKED))
def test_mixed_device_mask_raises(name):
    """A mask on another device than the features is held to the same
    rule as the features."""
    with pytest.raises(ValueError, match="CPU or CUDA"):
        MASKED[name](_t((1, 5) if name != "coarse_layer" else (1, 8),
                        "meta"))
