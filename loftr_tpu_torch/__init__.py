"""loftr_tpu_torch: the LoFTR matcher on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100), ported from the JAX package ``loftr_tpu``.

This package imports ``torch`` and ``numpy`` only; the JAX package is its
reference and is used by the tests alone.
"""
from loftr_tpu_torch.api import load_matcher, match_pair
from loftr_tpu_torch.config import get_config
from loftr_tpu_torch.models.matcher import LoFTR
from loftr_tpu_torch.structs import MatchInput, MatchResult

__all__ = ["LoFTR", "MatchInput", "MatchResult", "get_config",
           "load_matcher", "match_pair"]
