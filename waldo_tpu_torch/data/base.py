"""The part of waldo_tpu/data/base.py that the synthetic dataset uses: the
clip index, the phase's random stream, folds and the sample contract.

A dataset yields channel-last float32 numpy arrays:
  vid  (T, H, W, 3)   in [-1, 1]
  lyt  (T, H, W, Nl)  one-hot scaled 5*(2x-1)
  flow (T, Hf, Wf, 2) normalized 2*px/width
"""
from __future__ import annotations

import random
from typing import Dict, Optional


class BaseVideoDataset:
    def __init__(self, cfg, phase="train", rng: Optional[random.Random] = None,
                 fold: Optional[int] = None, num_folds: Optional[int] = None):
        self.cfg = cfg
        self.phase = phase
        self.rng = rng or random.Random(cfg.seed)
        self.dim = cfg.dim if cfg.load_dim == 0 else cfg.load_dim
        self.data = self.get_data(cfg, phase)
        self._full_clips = self.data["vid_frame_paths"]
        self.num_folds = num_folds
        if num_folds:
            self.set_fold(fold or 0)

    def set_fold(self, fold: int):
        """Select an interleaved shard of the clip index."""
        self.fold = fold % self.num_folds
        self.data = dict(self.data)
        self.data["vid_frame_paths"] = self._full_clips[self.fold:: self.num_folds]

    def get_data(self, cfg, phase) -> Dict:
        raise NotImplementedError

    def __len__(self):
        return len(self.data["vid_frame_paths"])
