"""Datasets and the batch loader (counterpart of waldo_tpu/data/)."""
from __future__ import annotations

from .base import BaseVideoDataset, make_dataset
from .cityscapes import CityscapesDataset
from .flo import read_flo, write_flo
from .kitti import KittiDataset
from .loader import DataLoader, InfiniteLoader, collate
from .synthetic import SyntheticDataset
from .video import VideoClipIndex, open_video, write_mjpeg_avi
from .video_folder import VideoFolderDataset

_REGISTRY = {
    "cityscapes": CityscapesDataset,
    "kitti": KittiDataset,
    "synthetic": SyntheticDataset,
    "video_folder": VideoFolderDataset,
}


def create_dataset(cfg, phase="train", **kw):
    name = cfg.data.dataset
    if name not in _REGISTRY:
        raise KeyError(f"unknown dataset '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg, phase=phase, **kw)
