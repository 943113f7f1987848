"""The SfM backend on the port (``loftr_tpu.sfm``): Lie utilities, pose
graph, Schur-complement bundle adjustment, trajectory error and
``pipeline.run_sfm``; ``python -m loftr_tpu_torch.sfm`` is its CLI."""
from loftr_tpu_torch.sfm.lie import exp_so3, exp_se3, log_so3
from loftr_tpu_torch.sfm.bundle_adjustment import (BAProblem, bundle_adjust,
                                                   reprojection_cost)
from loftr_tpu_torch.sfm.ate import align_umeyama, absolute_trajectory_error

__all__ = ["exp_so3", "exp_se3", "log_so3", "BAProblem", "bundle_adjust",
           "reprojection_cost", "align_umeyama",
           "absolute_trajectory_error"]
