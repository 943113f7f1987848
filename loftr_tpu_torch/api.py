"""One-call image-pair matching on the port (the reference's minimal
public surface, as ``loftr_tpu.api``).

    matcher = load_matcher()                  # seeded random init, on CUDA
    out = match_pair(img0, img1, matcher)     # {mkpts0, mkpts1, mconf}

    state = optimize_variables(matcher.state_dict())   # fold + pad
    fast = load_matcher(state_dict=state)     # config read off the state

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of carrying on on the CPU.
"""
from __future__ import annotations

import copy
from typing import Mapping, Optional

import numpy as np
import torch

from loftr_tpu_torch.config import get_config
from loftr_tpu_torch.models.matcher import LoFTR
from loftr_tpu_torch.structs import MatchInput
from loftr_tpu_torch.utils.weights import init_weights, load_checkpoint_state

__all__ = ["match_pair", "load_matcher", "optimize_variables"]


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "loftr_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    return dev


def _to_gray_batch(img) -> np.ndarray:
    """HxW / HxWx1 / HxWx3 (BGR: Rec601 gray) uint8/float -> [1,H,W,1]
    float32 in [0, 1]."""
    a = np.asarray(img)
    if a.ndim == 3 and a.shape[-1] == 3:
        a = a @ np.asarray([0.114, 0.587, 0.299], a.dtype)
    a = a.reshape(a.shape[:2])
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    return np.asarray(a, np.float32)[None, :, :, None]


def optimize_variables(state: Mapping[str, torch.Tensor]) -> dict:
    """The inference weight transforms of ``loftr_tpu.api``: BatchNorm
    folding (``utils/folding.py``) when the state has running statistics,
    then 196 -> 256 channel padding (``utils/channel_pad.py``; both keep
    the function).  The result feeds :func:`load_matcher` (``state_dict=``),
    :func:`match_pair` and ``serve.MatchingService``, which read the
    transformed backbone's config off it."""
    from loftr_tpu_torch.utils.channel_pad import pad_backbone_channels
    from loftr_tpu_torch.utils.folding import fold_batchnorm
    if any(k.endswith(".running_mean") for k in state):
        state = fold_batchnorm(state)
    return pad_backbone_channels(state)


def load_matcher(weights_path: Optional[str] = None,
                 preset: str = "indoor_ds", seed: int = 0,
                 device="cuda", state_dict: Optional[Mapping] = None
                 ) -> LoFTR:
    """A LoFTR matcher in eval mode on ``device``: weights from a reference
    ``.ckpt`` when a path is given, or from ``state_dict`` (for example the
    output of :func:`optimize_variables`), else a seeded random init (an
    untrained net finds few or no matches on real images).  With weights,
    the backbone's ``norm`` and ``block_dims`` are read off them, as
    ``loftr_tpu.api`` does, so folded or padded weights need no restated
    config.  ``preset`` is any name of ``config.PRESETS``; the OT presets
    (``indoor_ot``, ``outdoor_ot``, ``indoor_ot_buggy_pos_enc``) build the
    Sinkhorn matcher, whose learned ``coarse_matching.bin_score`` an OT
    checkpoint carries."""
    from loftr_tpu_torch.utils.channel_pad import infer_backbone_overrides
    dev = resolve_device(device)
    if state_dict is None and weights_path is not None:
        state_dict = load_checkpoint_state(weights_path)
    cfg = get_config(preset)
    if state_dict is not None:
        cfg = cfg.replaced({"loftr": infer_backbone_overrides(state_dict)})
    model = LoFTR(cfg.loftr)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        init_weights(model, seed)
    return model.eval().to(dev)


def with_config(matcher: LoFTR, overrides: dict) -> LoFTR:
    """A view of ``matcher`` sharing its parameters, with the model config
    overridden (e.g. ``{"dtype": "bfloat16"}``)."""
    from loftr_tpu_torch.config import _merge_dataclass
    view = copy.copy(matcher)
    view.config = _merge_dataclass(matcher.config, overrides)
    return view


def match_pair(img0, img1, matcher, dtype: str = "bfloat16",
               use_pallas: bool = True, min_conf: float = 0.0,
               preset: str = "indoor_ds", device="cuda"):
    """Match two grayscale images; the reference's 3-key output contract.

    img0/img1: HxW (or HxWx1/x3) arrays, uint8 or float; H and W multiples
    of 8.  ``matcher``: a LoFTR module (it runs on the module's device), or
    a state dict, from which :func:`load_matcher` builds one with
    ``preset`` on ``device`` for this call (pass the module to repeated
    calls).  Returns dict(mkpts0 [M,2],
    mkpts1 [M,2], mconf [M]) as numpy, valid matches only, pixel (x, y).
    ``use_pallas=False`` turns off the matcher and fine-stage kernels, as
    ``loftr_tpu.api.match_pair`` does; the coarse layer keeps the matcher's
    ``coarse.use_pallas``.
    """
    if isinstance(matcher, Mapping):
        matcher = load_matcher(preset=preset, device=device,
                               state_dict=matcher)
    dev = next(matcher.parameters()).device
    model = with_config(matcher, {
        "dtype": dtype,
        "match_coarse": {"use_pallas": use_pallas},
        "fine": {"use_pallas": use_pallas}})
    inp = MatchInput(image0=torch.from_numpy(_to_gray_batch(img0)).to(dev),
                     image1=torch.from_numpy(_to_gray_batch(img1)).to(dev))
    out = model(inp)
    valid = out.valid[0].cpu().numpy()
    conf = out.coarse.mconf[0].float().cpu().numpy()
    keep = valid & (conf >= min_conf)
    return {
        "mkpts0": out.mkpts0_f[0].float().cpu().numpy()[keep],
        "mkpts1": out.mkpts1_f[0].float().cpu().numpy()[keep],
        "mconf": conf[keep],
    }
