"""The port's CUDA kernels: one module a kernel, each with its wrapper,
plain PyTorch version and launch counter (an attribute of the wrapper that
counts the calls that launched the kernel)."""


def _counters():
    from loftr_tpu_torch.ops.kernels.coarse_layer import fused_coarse_layer
    from loftr_tpu_torch.ops.kernels.dual_softmax import \
        fused_dual_softmax_match
    from loftr_tpu_torch.ops.kernels.fine_stage import fused_fine_stage
    from loftr_tpu_torch.ops.kernels.focal_loss import fused_focal_sums
    from loftr_tpu_torch.ops.kernels.sinkhorn import fused_sinkhorn_match
    from loftr_tpu_torch.ops.kernels.upsample import (upsample2x,
                                                      upsample2x_add)
    from loftr_tpu_torch.ops.kernels.window_attention import \
        window_linear_attention
    return {"coarse_layer": (fused_coarse_layer, "launches"),
            "sinkhorn": (fused_sinkhorn_match, "launches"),
            "window_attention": (window_linear_attention, "launches"),
            "upsample": (upsample2x, "launches"),
            "upsample_add": (upsample2x_add, "launches"),
            "dual_softmax": (fused_dual_softmax_match, "launches"),
            "fine_stage": (fused_fine_stage, "launches"),
            "focal_loss_forward": (fused_focal_sums, "launches"),
            "focal_loss_backward": (fused_focal_sums, "backward_launches")}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def launch_counts() -> dict:
    """Every kernel's launch counter, by kernel name (the focal loss's
    forward and backward apart)."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}
