"""Host-side batch loader with background prefetch.

Replacement for torch DataLoader workers
(SURVEY.md §2.4 "Multi-process data loading"): a thread pool assembles numpy
batches ahead of time; the training loop overlaps host assembly with device
steps (jax dispatch is async, so one batch of lookahead suffices to hide
host time for these small batches).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def collate(items) -> Dict[str, np.ndarray]:
    out = {}
    for k in items[0]:
        out[k] = np.stack([np.asarray(it[k]) for it in items])
    return out


class DataLoader:
    """Shuffling, drop-last batch iterator with optional thread prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, num_prefetch: int = 2,
                 num_workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.num_prefetch = num_prefetch
        self.num_workers = max(num_workers, 1)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_iter(self):
        n = len(self.dataset)
        idx = self.rng.permutation(n) if self.shuffle else np.arange(n)
        stop = n - n % self.batch_size if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            yield idx[s:s + self.batch_size]

    def _make_batch(self, batch_idx):
        return collate([self.dataset[int(i)] for i in batch_idx])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_prefetch <= 0:
            for bi in self._index_iter():
                yield self._make_batch(bi)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.num_prefetch)
        sentinel = object()

        def producer():
            try:
                for bi in self._index_iter():
                    q.put(self._make_batch(bi))
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item


def infinite_batches(loader: DataLoader):
    while True:
        yield from loader
