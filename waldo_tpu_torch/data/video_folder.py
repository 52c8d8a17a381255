"""Video-file folder dataset (the port's copy of
waldo_tpu/data/video_folder.py): clips cut out of the video files under
``dataroot/<split>`` (or ``dataroot``) through a ``VideoClipIndex`` with a
metadata pickle cache. RGB only: the layout and flow sidecars exist only for
the frame-folder datasets."""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from .base import BaseVideoDataset
from .video import VIDEO_EXTENSIONS, load_or_build_clip_index


class VideoFolderDataset(BaseVideoDataset):
    def get_data(self, cfg, phase) -> Dict:
        root = cfg.data.dataroot
        split = {"train": "train", "valid": "valid", "test": "test"}[phase]
        base = os.path.join(root, split)
        if not os.path.isdir(base):
            base = root
        vids: List[str] = []
        for dirpath, _dirs, files in sorted(os.walk(base)):
            for f in sorted(files):
                if f.lower().endswith(VIDEO_EXTENSIONS):
                    vids.append(os.path.join(dirpath, f))
        # one "clip" per file, for the base class's folds
        return {"vid_paths": vids, "vid_frame_paths": [[p] for p in vids]}

    def __init__(self, cfg, phase="train", rng=None, fold=None, num_folds=None):
        if cfg.data.load_lyt or cfg.data.load_flow:
            raise ValueError("video-file datasets are RGB only: set --data.load_lyt false "
                             "and --data.load_flow false")
        super().__init__(cfg, phase=phase, rng=rng, fold=fold, num_folds=num_folds)
        d = cfg.data
        per_clip = (d.load_vid_len if (d.load_vid_len is not None and phase == "train")
                    else d.vid_len)
        self._per_clip = per_clip
        cache = self.serialized_path("metadata", phase)
        self.vid_clips = load_or_build_clip_index(
            self.data["vid_paths"], per_clip, d.vid_skip, cache, force=d.force_compute_metadata)

    def __len__(self):
        return self.vid_clips.num_clips()

    def _select_frames(self, frame_ids):
        # the clip cut has already applied skip_first and one_every_n: keep
        # only the window selection of a training clip
        d = self.cfg.data
        if d.load_vid_len is None or self.phase != "train":
            return frame_ids[: d.vid_len]
        return super()._select_frames(frame_ids)

    def draw(self, index: int):
        aug = self.sample_augmentation()
        return aug, self._select_frames(list(range(self._per_clip)))

    def make_clip(self, index: int, draws) -> Dict[str, np.ndarray]:
        aug, idx = draws
        clip = self.vid_clips.get_clip(index)  # (per_clip, H, W, 3) uint8
        vi, start = self.vid_clips.clips[index]
        return {"path": f"{self.data['vid_paths'][vi]}#{start}",
                "vid": np.stack([self.rgb_from_array(clip[i], aug) for i in idx])}
