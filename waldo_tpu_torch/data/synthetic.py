"""Synthetic moving-shapes clips with exact flow and layouts (the port's copy
of waldo_tpu/data/synthetic.py, the same numbers for the same phase, index
and seed; a valid or test clip's seed is the port's own, ``eval_seed``).

An offline stand-in with the real datasets' sample contract: each clip holds
a translating textured background and 1-3 moving rectangles; the layout
marks background and object classes and the flow is the exact per-pixel
displacement from the previous frame (normalized 2*px/W, 0 at frame 0).
"""
from __future__ import annotations

import zlib

import numpy as np

from .base import BaseVideoDataset


class SyntheticDataset(BaseVideoDataset):
    num_clips = {"train": 64, "valid": 8, "test": 8}

    def get_data(self, cfg, phase):
        return {"vid_frame_paths": [[f"synthetic_{phase}_{i}"]
                                    for i in range(self.num_clips[phase])]}

    def draw(self, index) -> int:
        """A training clip's seed is the phase stream's next draw; the
        others' come from (phase, index) alone (``eval_seed``)."""
        if self.phase == "train":
            return self.rng.randrange(2 ** 31)
        return self.eval_seed(self.phase, index)

    @staticmethod
    def eval_seed(phase, index) -> int:
        """The seed of a valid or test clip: the same in every process, so
        that the ranks of a data-parallel run and the runs of one
        configuration evaluate the same clips. (The JAX package takes
        ``hash((phase, index))``, which Python's string hashing makes stable
        within one process only: ROADMAP.md section 3.)"""
        return zlib.crc32(f"{phase}/{index}".encode()) % (2 ** 31)

    def make_clip(self, index, seed):
        """The clip at ``index`` made from ``seed``; reads no shared state,
        so the loader's workers run it in parallel."""
        cfg, d = self.cfg, self.cfg.data
        t = d.vid_len
        h = self.dim
        w = int(self.dim * cfg.aspect_ratio)
        fdim = cfg.flow_dim if cfg.flow_dim > 0 else cfg.dim
        fh, fw = fdim, int(fdim * cfg.aspect_ratio)
        rng = np.random.RandomState(seed)

        nl = d.num_lyt
        bg_cls = (d.bg_idx or [0])[0]
        fg_classes = d.fg_idx or [1]

        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        # textured background (smooth random sinusoids)
        fr = rng.rand(6) * 0.2 + 0.02
        ph = rng.rand(6) * 6.28
        amp = rng.rand(6, 3)

        def bg_tex(ox, oy):
            v = sum(
                amp[i][:, None, None] * np.sin(fr[i] * ((xx + ox) + (1.3 + i) * (yy + oy)) + ph[i])
                for i in range(6)
            )
            return (v / 3.0).transpose(1, 2, 0).astype(np.float32)

        bg_vel = rng.randn(2) * 1.5  # px/frame
        objs = []
        for _ in range(rng.randint(1, 4)):
            objs.append(dict(
                cx=rng.rand() * w, cy=rng.rand() * h,
                vx=rng.randn() * 3.0, vy=rng.randn() * 1.5,
                rw=rng.rand() * w * 0.12 + w * 0.05,
                rh=rng.rand() * h * 0.2 + h * 0.08,
                color=rng.rand(3) * 2 - 1,
                cls=fg_classes[rng.randint(len(fg_classes))],
            ))

        vid = np.zeros((t, h, w, 3), np.float32)
        lyt_idx = np.zeros((t, h, w), np.int64)
        flow = np.zeros((t, h, w, 2), np.float32)
        for k in range(t):
            frame = bg_tex(bg_vel[0] * k, bg_vel[1] * k)
            lab = np.full((h, w), bg_cls, np.int64)
            fl = np.broadcast_to(-np.asarray(bg_vel, np.float32), (h, w, 2)).copy()
            for o in objs:
                cx, cy = o["cx"] + o["vx"] * k, o["cy"] + o["vy"] * k
                mask = (np.abs(xx - cx) < o["rw"]) & (np.abs(yy - cy) < o["rh"])
                frame[mask] = o["color"]
                lab[mask] = o["cls"]
                fl[mask] = [-o["vx"], -o["vy"]]
            vid[k] = np.clip(frame, -1, 1)
            lyt_idx[k] = lab
            # displacement from frame k-1 to k, at frame k
            flow[k] = fl if k > 0 else 0.0
        flow[..., 0] *= 2.0 / w
        flow[..., 1] *= 2.0 / h

        onehot = np.zeros((t, h, w, nl), np.float32)
        np.put_along_axis(onehot, lyt_idx[..., None], 1.0, axis=-1)
        out = {
            "path": self.data["vid_frame_paths"][index][0],
            "vid": vid,
            "lyt": 5.0 * (2 * onehot - 1),
        }
        if (fh, fw) != (h, w):
            step_h, step_w = h // fh, w // fw
            out["flow"] = flow[:, ::step_h, ::step_w][:, :fh, :fw]
        else:
            out["flow"] = flow
        return out
