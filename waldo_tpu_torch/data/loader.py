"""Prefetching batch loader (counterpart of waldo_tpu/data/loader.py):
shuffled epochs from a seeded permutation, drop_last, and a producer thread
that makes each batch's clips on a pool of ``num_workers`` threads and keeps
up to ``prefetch`` batches ready in a bounded queue.

``batch_size`` is the global batch. Under data parallelism over ``world_size``
processes (by default the process group's, parallel/mesh.py), rank r holds
rows [r B/W, (r+1) B/W) of each global batch; ``len`` is the number of
global batches, as at world 1.

A batch does not depend on ``num_workers`` or the world size. Every
dataset splits its draws from a shared random stream (the synthetic
training clips' seeds, the frame datasets' augmentation and frame choice)
from the work: ``draw(index)`` runs on the producer for every row of the
global batch, in order, and ``make_clip(index, draws)`` on the workers for
the rank's rows only, so rank r's clips are world 1's rows. (The JAX
loader gives each host a contiguous slab of the epoch instead, and its
hosts, which seed the same stream, make the same synthetic clips: ROADMAP.md
section 3.)

A worker's exception reaches the consumer as ``RuntimeError("data loader
worker failed")``; a producer that ends without a result fails the
consumer too, so it never waits for ever. Leaving the iterator early (or
closing it) stops the producer.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from ..parallel import mesh

_POLL_S = 0.1  # how often a blocked producer or consumer looks at the other


def collate(samples) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        if isinstance(samples[0][k], np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2, drop_last: bool = True,
                 world_size: Optional[int] = None, rank: Optional[int] = None):
        self.world_size = mesh.world_size() if world_size is None else world_size
        self.rank = mesh.rank() if rank is None else rank
        if batch_size % self.world_size:
            raise ValueError(f"a global batch of {batch_size} does not split over "
                             f"{self.world_size} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        return idx

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _make_batch(self, pool, bidx):
        ds = self.dataset
        draws = [ds.draw(i) for i in bidx]  # the stream's draws for every row, in order
        n, w, r = len(bidx), self.world_size, self.rank
        mine = slice(r * n // w, (r + 1) * n // w)
        return collate(list(pool.map(ds.make_clip, bidx[mine], draws[mine])))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_indices()
        batches = [idx[i: i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for bidx in batches:
                        if stop.is_set() or not put(self._make_batch(pool, bidx)):
                            return
            except BaseException as e:  # noqa: BLE001 -- re-raised in the consumer
                put(e)
                return
            put(None)

        th = threading.Thread(target=produce, name="DataLoader producer", daemon=True)
        th.start()
        try:
            while True:
                try:
                    item = q.get(timeout=_POLL_S)
                except queue.Empty:
                    if th.is_alive() or not q.empty():
                        continue
                    raise RuntimeError("data loader worker failed: the producer ended "
                                       "without a result") from None
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise RuntimeError("data loader worker failed") from item
                yield item
        finally:
            stop.set()


class InfiniteLoader:
    """Epoch-cycling iterator that advances the dataset's fold each epoch."""

    def __init__(self, loader: DataLoader):
        self.loader = loader
        self.epoch = 0
        self._it = iter(loader)

    def next(self):
        try:
            return next(self._it)
        except StopIteration:
            self.epoch += 1
            self.loader.set_epoch(self.epoch)
            ds = self.loader.dataset
            if getattr(ds, "num_folds", None):
                ds.set_fold(ds.fold + 1)
            self._it = iter(self.loader)
            return next(self._it)

    def close(self):
        """Stop the current epoch's producer."""
        self._it.close()
