"""Prefetching batch loader.

Port of ``geomae_tpu/data/loader.py:PrefetchLoader``: worker threads build
padded numpy batches ahead of the train loop, so host IO and augmentation
overlap device compute (numpy releases the interpreter lock in its array
work).  The trainer pins each batch and copies it to the card ahead of
the step (``train/trainer.py``).  In a data-parallel run each rank's
loader builds only its rows of every global batch, each sample with the
seed of its global position, so the ranks' rows stacked in rank order
are the batch one process would build.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class PrefetchLoader:
    """Iterates shuffled batches with background workers.

    Args:
      dataset: indexable with ``__getitem__(idx, seed=...) -> dict`` of
        fixed-shape numpy arrays.
      batch_size: global batch (stack along axis 0).
      num_workers: worker threads; 0 = synchronous.
      seed: shuffling + per-sample augmentation seed.
      rank, world: this loader yields rows ``[rank * b, (rank + 1) * b)``
        of each global batch, ``b = batch_size // world``.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 2, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 4, rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"a global batch of {batch_size} does not "
                             f"divide over {world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rows = batch_size // world
        self.first = rank * self.rows
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _index_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def _build_batch(self, indices, base_seed) -> dict:
        """This rank's rows of the global batch ``indices``: sample j of
        the global batch takes the seed ``base_seed + j``."""
        mine = range(self.first, self.first + self.rows)
        samples = [self.dataset.__getitem__(int(indices[j]),
                                            seed=int(base_seed + j))
                   for j in mine]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def __iter__(self) -> Iterator[dict]:
        order = self._index_order()
        nb = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        base = (self.seed + self.epoch * 1_000_003) % (2**31)
        self.epoch += 1

        if self.num_workers <= 0:
            for bi, b in enumerate(batches):
                yield self._build_batch(b, base + bi * self.batch_size)
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        task_q: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            task_q.put((bi, b))
        stop = threading.Event()

        def put(item) -> bool:
            """Hand ``item`` over unless the consumer has gone away."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            while not stop.is_set():
                try:
                    bi, b = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = self._build_batch(b, base + bi * self.batch_size)
                except Exception as e:       # raised again in the consumer:
                    put((bi, e))             # a silent worker death would
                    return                   # hang the training loop
                if not put((bi, batch)):
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            next_bi = 0
            pending = {}
            for _ in range(nb):
                while next_bi not in pending:
                    bi, batch = out_q.get()
                    if isinstance(batch, Exception):
                        raise batch
                    pending[bi] = batch
                yield pending.pop(next_bi)
                next_bi += 1
        finally:
            stop.set()       # a consumer that stops early frees the workers
            for t in threads:
                t.join()
