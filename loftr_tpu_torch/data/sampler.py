"""Scene-balanced sampling over concatenated per-scene datasets.

A copy of ``loftr_tpu.data.sampler`` (the reference's
src/datasets/sampler.py:5-77) with a numpy
Generator: each epoch draws n_samples_per_subset indices from every scene
(with or without replacement), optionally shuffles across scenes and repeats.
The sampler is stateful across epochs (same NOTE as sampler.py:15) and
assumes the dataset list is already sharded across hosts, not replicated
(sampler.py:16-17 - see data/sharding.py).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


class ConcatDataset:
    """Minimal concat view over a list of datasets (torch-free)."""

    def __init__(self, datasets: Sequence):
        assert len(datasets) > 0
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cumulative_sizes[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self.cumulative_sizes, idx, side="right"))
        low = 0 if d == 0 else int(self.cumulative_sizes[d - 1])
        return self.datasets[d][idx - low]


class SceneBalancedSampler:
    def __init__(self, data_source: ConcatDataset, n_samples_per_subset: int,
                 subset_replacement: bool = True, shuffle: bool = True,
                 repeat: int = 1, seed: int | None = None):
        self.data_source = data_source
        self.n_subset = len(data_source.datasets)
        self.n_samples_per_subset = n_samples_per_subset
        self.n_samples = self.n_subset * n_samples_per_subset * repeat
        self.subset_replacement = subset_replacement
        self.shuffle = shuffle
        self.repeat = repeat
        self.rng = np.random.default_rng(seed)
        assert repeat >= 1

    def __len__(self):
        return self.n_samples

    def __iter__(self):
        chunks: List[np.ndarray] = []
        for d_idx in range(self.n_subset):
            low = 0 if d_idx == 0 else \
                int(self.data_source.cumulative_sizes[d_idx - 1])
            high = int(self.data_source.cumulative_sizes[d_idx])
            if self.subset_replacement:
                idx = self.rng.integers(low, high, self.n_samples_per_subset)
            else:
                n = high - low
                perm = self.rng.permutation(n) + low
                if n >= self.n_samples_per_subset:
                    idx = perm[: self.n_samples_per_subset]
                else:
                    pad = self.rng.integers(
                        low, high, self.n_samples_per_subset - n)
                    idx = np.concatenate([perm, pad])
            chunks.append(idx)
        indices = np.concatenate(chunks)
        if self.shuffle:
            indices = indices[self.rng.permutation(len(indices))]
        if self.repeat > 1:
            reps = [indices.copy() for _ in range(self.repeat - 1)]
            if self.shuffle:
                reps = [r[self.rng.permutation(len(r))] for r in reps]
            indices = np.concatenate([indices, *reps])
        assert len(indices) == self.n_samples
        return iter(indices.tolist())
