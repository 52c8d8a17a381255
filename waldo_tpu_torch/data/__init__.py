"""Datasets and the batch loader (counterpart of waldo_tpu/data/).

Only the synthetic dataset is ported; Cityscapes, KITTI and the video
folders come with the data slice, once those datasets are in the repo."""
from __future__ import annotations

from .base import BaseVideoDataset
from .loader import DataLoader, InfiniteLoader, collate
from .synthetic import SyntheticDataset

_REGISTRY = {"synthetic": SyntheticDataset}
_NOT_PORTED = ("cityscapes", "kitti", "video_folder")


def create_dataset(cfg, phase="train", **kw):
    name = cfg.data.dataset
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"the {name!r} dataset is not ported yet (ROADMAP.md queue: the data slice); "
            f"set --dataset synthetic")
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg, phase=phase, **kw)
