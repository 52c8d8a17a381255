"""KITTI sequence dataset (the port's copy of waldo_tpu/data/kitti.py)."""
from __future__ import annotations

import os

from .base import BaseVideoDataset, make_dataset


class KittiDataset(BaseVideoDataset):
    def get_data(self, cfg, phase):
        d = cfg.data
        root = d.dataroot
        name = "all_vid" if d.load_all else "vid"
        if cfg.true_dim != 375:
            self.frame_folder = os.path.join(root, f"{name}_{cfg.true_dim}")
            self.layout_folder = os.path.join(root, f"{name}_{d.lyt_model}_{cfg.true_dim}")
            self.flow_folder = os.path.join(root, f"{name}_{d.flow_model}_{cfg.true_dim}")
        else:
            self.frame_folder = os.path.join(root, name)
            self.layout_folder = os.path.join(root, f"{name}_{d.lyt_model}")
            self.flow_folder = os.path.join(root, f"{name}_{d.flow_model}")
        if cfg.flow_dim != 0:
            self.flow_folder = os.path.join(root, f"{name}_{d.flow_model}_{cfg.flow_dim}")

        split = "train" if phase in ("train", "valid") else "test"
        frame_paths = make_dataset(os.path.join(self.frame_folder, split), recursive=True)

        frame_dic = {}
        for path in sorted(frame_paths):
            seq = path.split("/")[-4]
            frame_dic.setdefault(seq, []).append(path)
        vid_frame_paths = [sorted(paths) for paths in frame_dic.values()]

        if phase in ("train", "valid"):
            cut = int(0.1 * len(vid_frame_paths))
            vid_frame_paths = vid_frame_paths[cut:] if phase == "train" else vid_frame_paths[:cut]
        frame_paths = [p for vid in vid_frame_paths for p in vid]

        # chunk long videos: 20-frame chunks to train on, every window to test on
        new_vid = []
        if phase in ("train", "valid"):
            n = 20
            for paths in vid_frame_paths:
                chunks = len(paths) // n
                for k in range(chunks):
                    start = k * n
                    new_vid.append(paths[start: start + n] if k < chunks - 1 else paths[start:])
        else:
            # a test window holds vid_len frames after the one skip_first
            # drops (the JAX package's hold vid_len in all, so that with
            # skip_first, which the KITTI scripts set, no clip can be loaded)
            n = d.vid_len + int(d.skip_first)
            for paths in vid_frame_paths:
                for k in range(1, len(paths) - d.vid_len):
                    new_vid.append(paths[k: k + n])
        if "demo" in root:
            new_vid = new_vid[:1]
        return {"frame_paths": frame_paths, "vid_frame_paths": new_vid}
