"""Scene-level sharding across hosts (train-time data parallelism).

A copy of ``loftr_tpu.data.sharding`` (the reference's
src/utils/dataloader.py:6-23): seeded
permutation of the scene list, pad to a multiple of world_size with seeded
replacement choices, contiguous slice per rank.  For val/test the framework
instead shards pair indices exactly (eval/evaluator.py), making the
reference's duplicate-filtering (metrics.py:179-182) unnecessary.
"""
from __future__ import annotations

import numpy as np


def get_local_split(items, world_size: int, rank: int, seed: int):
    items = list(items)
    n_items = len(items)
    permuted = np.random.RandomState(seed).permutation(items)
    if n_items % world_size != 0:
        padding = np.random.RandomState(seed).choice(
            items, world_size - (n_items % world_size), replace=True)
        permuted = np.concatenate([permuted, padding])
    n_per_rank = len(permuted) // world_size
    return list(permuted[n_per_rank * rank: n_per_rank * (rank + 1)])
