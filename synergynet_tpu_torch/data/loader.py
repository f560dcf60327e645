"""Prefetching batch loader: threaded augment + batch assembly.

Counterpart of ``synergynet_tpu/data/loader.py`` for one process (the
reference's ``DataLoader(bs=1024, workers=8, pin_memory=True)``,
main_train.py:207-209):

- a thread pool fetches and augments samples (the numpy colour math
  releases the GIL in its C loops) and stacks fixed-shape uint8 batches;
- a small queue keeps ``prefetch`` batches in flight, so host work
  overlaps the card's step;
- batches stay uint8 until the train step normalizes them on the card;
- each epoch's order comes from ``SeedSequence([seed, epoch])`` and each
  sample's rng from ``SeedSequence([seed, epoch, index])``, as in the JAX
  loader, so both packages see the same batches, bit for bit, whatever the
  thread scheduling.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np


class PrefetchLoader:
    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _fetch(self, index: int) -> Tuple:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index]))
        item = self.dataset.__getitem__(index, rng=rng)
        return item if isinstance(item, tuple) else (item,)

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch])).shuffle(order)
        nb = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        idx = order[b * self.batch_size:
                                    (b + 1) * self.batch_size]
                        samples = list(pool.map(self._fetch, idx))
                        parts = tuple(np.stack([s[i] for s in samples])
                                      for i in range(len(samples[0])))
                        out_q.put(parts if len(parts) > 1 else parts[0])
            except Exception as e:          # re-raised in the consumer
                failure.append(e)
            finally:
                out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    if failure:
                        raise failure[0]
                    return
                yield batch
        finally:
            stop.set()
            # Drain so the producer can finish if we stopped early.
            while t.is_alive():
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
