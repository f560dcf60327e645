"""Prefetching batch loader: threaded augment + batch assembly.

Counterpart of ``synergynet_tpu/data/loader.py`` (the reference's ``DataLoader(bs=1024, workers=8, pin_memory=True)``,
main_train.py:207-209):

- a thread pool fetches and augments samples (the numpy colour math
  releases the GIL in its C loops) and stacks fixed-shape uint8 batches;
- a dataset with ``fetch_batch(indices)`` and no host transform (the
  streaming ``GeneratedCropDataset``) is fetched whole slabs at a time,
  one slab per thread, as in the JAX loader;
- a small queue keeps ``prefetch`` batches in flight, so host work
  overlaps the card's step;
- batches stay uint8 until the train step normalizes them on the card;
- each epoch's order comes from ``SeedSequence([seed, epoch])`` and each
  sample's rng from ``SeedSequence([seed, epoch, index])``, as in the JAX
  loader, so both packages see the same batches, bit for bit, whatever the
  thread scheduling;
- ``process_index`` / ``process_count`` shard the dataset over the data
  rows of a mesh: every row takes a strided slice of the same shuffled
  order, and every row steps the same number of batches.
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
                 prefetch: int = 2, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        """``process_index`` / ``process_count``: this rank's data row and
        the mesh's data size (not the rank and the world size: the model
        columns of a row read the same rows)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = max(1, process_count)

    def __len__(self) -> int:
        if self.drop_last:
            # Agreed by every data row: row p's strided shard holds
            # ceil((n - p) / P) rows, at least floor(n / P), so every row
            # steps to that bound. A row that stepped more would wait
            # forever in the step's collectives.
            return (len(self.dataset) // self.process_count) \
                // self.batch_size
        n = (len(self.dataset) - self.process_index + self.process_count
             - 1) // self.process_count
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
        if self.process_count > 1:
            order = order[self.process_index::self.process_count]
        nb = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []
        batched = (getattr(self.dataset, "fetch_batch", None)
                   if getattr(self.dataset, "transform", None) is None
                   else None)

        def make_batch(pool, idx):
            if batched is None:
                samples = list(pool.map(self._fetch, idx))
                return tuple(np.stack([s[i] for s in samples])
                             for i in range(len(samples[0])))
            slabs = np.array_split(
                idx, max(1, min(self.num_workers, len(idx) // 128)))
            parts = list(pool.map(batched, slabs))
            return tuple(np.concatenate([p[i] for p in parts])
                         for i in range(len(parts[0])))

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        parts = make_batch(pool, order[
                            b * self.batch_size:(b + 1) * self.batch_size])
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


def shard_batches(loader, mesh=None):
    """Each batch of ``loader`` (this rank's rows) as tensors on the mesh
    rank's device (:func:`~synergynet_tpu_torch.core.mesh.shard_batch`);
    batches as they come without a mesh."""
    from synergynet_tpu_torch.core.mesh import shard_batch
    for batch in loader:
        yield batch if mesh is None else shard_batch(mesh, batch)
