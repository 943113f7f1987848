"""Evaluation: epipolar and pose metrics, pose solvers on the host and the
device, and the dataset evaluator (the counterpart of ``loftr_tpu.eval``)."""
