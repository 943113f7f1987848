"""Runnable examples on the port: ``python -m
loftr_tpu_torch.examples.match_pair`` and ``python -m
loftr_tpu_torch.examples.serve``."""
