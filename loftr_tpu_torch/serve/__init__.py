"""Serving: a thread-safe micro-batching matcher service on the card
(``loftr_tpu.serve``): requests grouped into batches per resolution
bucket and batch rung, with host stacking, dispatch and result fetches
pipelined against the card's work."""
from loftr_tpu_torch.serve.service import (MatchingService, ServiceStats,
                                           pick_bucket, preprocess_to_bucket)

__all__ = ["MatchingService", "ServiceStats", "pick_bucket",
           "preprocess_to_bucket"]
