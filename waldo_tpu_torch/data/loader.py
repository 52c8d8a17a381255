"""Batch loader (counterpart of waldo_tpu/data/loader.py), in one process:
shuffled epochs from a seeded permutation, drop_last, the clips of a batch
made in order (a training clip draws its seed from the dataset's stream, so
the order fixes the data)."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


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
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
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

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_indices()
        for i in range(0, len(idx), self.batch_size):
            yield collate([self.dataset[j] for j in idx[i: i + self.batch_size]])


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
