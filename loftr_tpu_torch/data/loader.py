"""Batching + threaded prefetching loader (host-side input pipeline); the
counterpart of ``loftr_tpu.data.loader``.

A thread-pool pipeline in place of the reference's DataLoader worker
processes (train.py:36, data.py:75-91): cv2/h5py release the GIL during
decode, so threads keep the device fed without process overhead.  Emits the
port's MatchInput of stacked CPU tensors, plus a metadata list (scene/pair
ids) that stays on the host; moving a batch to the device is the caller's
job.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from loftr_tpu_torch.structs import MatchInput

_META_KEYS = ("dataset_name", "scene_id", "pair_id", "pair_names")


def collate_matchinput(items: List[dict]):
    """Stack per-pair dicts -> (MatchInput of CPU tensors, meta list)."""
    keys = items[0].keys()
    arrays = {}
    for k in keys:
        if k in _META_KEYS:
            continue
        vals = [np.asarray(it[k]) for it in items]
        arrays[k] = np.stack(vals)
    meta = [{k: it.get(k) for k in _META_KEYS} for it in items]

    def get(k):
        v = arrays.get(k)
        if v is None or v.size == 0:  # test-mode empty depths
            return None
        return torch.from_numpy(v)

    inp = MatchInput(
        image0=get("image0"), image1=get("image1"),
        mask0=get("mask0"), mask1=get("mask1"),
        scale0=get("scale0"), scale1=get("scale1"),
        depth0=get("depth0"), depth1=get("depth1"),
        T_0to1=get("T_0to1"), T_1to0=get("T_1to0"),
        K0=get("K0"), K1=get("K1"),
    )
    return inp, meta


class DataLoader:
    """Iterate a dataset by sampler order in batches, prefetching ahead."""

    def __init__(self, dataset, batch_size: int = 1,
                 sampler: Optional[Iterable[int]] = None,
                 num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last

    def _index_batches(self) -> Iterator[List[int]]:
        order = list(self.sampler) if self.sampler is not None \
            else list(range(len(self.dataset)))
        for i in range(0, len(order), self.batch_size):
            chunk = order[i: i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield chunk

    def __iter__(self):
        batches = self._index_batches()
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_batch(idxs):
            items = list(pool.map(self.dataset.__getitem__, idxs))
            return collate_matchinput(items)

        def producer():
            try:
                for idxs in batches:
                    if stop.is_set():
                        return
                    q.put(load_batch(idxs))
            except Exception as e:  # surface loader errors to the consumer
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False)
