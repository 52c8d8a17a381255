"""Cityscapes sequence dataset (the port's copy of waldo_tpu/data/cityscapes.py):
``leftImg8bit_sequence[_<true_dim>]/<split>/<city>/<city>_<seq>_<frame>_leftImg8bit.png``
with the layout and flow trees beside it; sequences of 29 or 30 frames are
taken whole, other runs are split where the frame numbers jump; train and
valid share the train split, cut 0.9 / 0.1."""
from __future__ import annotations

import os

from .base import BaseVideoDataset, make_dataset


class CityscapesDataset(BaseVideoDataset):
    def get_data(self, cfg, phase):
        d = cfg.data
        root = d.dataroot
        if cfg.true_dim != 1024:
            self.frame_folder = os.path.join(root, f"leftImg8bit_sequence_{cfg.true_dim}")
            self.layout_folder = os.path.join(root, f"leftImg8bit_sequence_{d.lyt_model}_{cfg.true_dim}")
            self.flow_folder = os.path.join(root, f"leftImg8bit_sequence_{d.flow_model}_{cfg.true_dim}")
        else:
            self.frame_folder = os.path.join(root, "leftImg8bit_sequence")
            self.layout_folder = os.path.join(root, f"leftImg8bit_sequence_{d.lyt_model}")
            self.flow_folder = os.path.join(root, f"leftImg8bit_sequence_{d.flow_model}")
        if cfg.flow_dim != 0:
            self.flow_folder = os.path.join(root, f"leftImg8bit_sequence_{d.flow_model}_{cfg.flow_dim}")

        split = "train" if phase in ("train", "valid") else "val"
        frame_paths = make_dataset(os.path.join(self.frame_folder, split), recursive=True)

        frame_dic = {}
        for path in sorted(frame_paths):
            seq = "_".join(os.path.basename(path).split("_")[:2])
            frame_dic.setdefault(seq, []).append(path)

        vid_frame_paths = list(frame_dic.values())
        vid_len = d.vid_len if d.load_vid_len is None else d.load_vid_len
        new_paths = []
        for l in vid_frame_paths:
            if len(l) in (29, 30):
                new_paths.append(l)
            else:
                # split a sequence where its frame numbers jump
                seq = [l[0]]
                curr = int(os.path.basename(l[0]).split("_")[2])
                for i in range(len(l) - 1):
                    nxt = int(os.path.basename(l[i + 1]).split("_")[2])
                    if nxt == curr + 1:
                        seq.append(l[i + 1])
                    else:
                        if len(seq) >= vid_len:
                            new_paths.append(seq)
                        seq = [l[i + 1]]
                    curr = nxt
        vid_frame_paths = new_paths

        if phase in ("train", "valid"):
            cut = int(0.9 * len(vid_frame_paths))
            vid_frame_paths = vid_frame_paths[:cut] if phase == "train" else vid_frame_paths[cut:]
        frame_paths = [p for vid in vid_frame_paths for p in vid]
        return {"frame_paths": frame_paths, "vid_frame_paths": vid_frame_paths}
