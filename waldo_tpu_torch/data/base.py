"""Base video dataset: clip index, loaders, host-side augmentation (the
port's copy of waldo_tpu/data/base.py).

A dataset yields channel-last float32 numpy arrays:
  vid  (T, H, W, 3)   in [-1, 1]
  lyt  (T, H, W, Nl)  one-hot scaled 5*(2x-1)
  flow (T, Hf, Wf, 2) normalized 2*px/width

Augmentation: random zoom-crop (zoom in [max(1, ar/true_ratio), max_zoom]),
optional flips (sign-corrected flow), colour jitter on RGB only, in the JAX
package's fixed order (brightness, contrast, saturation, hue). Every draw
comes from the dataset's ``random.Random`` in the JAX package's order
(``sample_augmentation``, then ``_select_frames``), so both packages draw
the same clip for the same stream. ``draw(index)`` makes a clip's draws and
``make_clip(index, draws)`` loads it; the loader calls the first in batch
order on its producer and the second on its clip threads.

Frames decode with Pillow. The layout, the flow and the unjittered RGB go
through the C++ library (``data/native.py``) on every call; jittered RGB and
the video-file frames go through Pillow's bilinear resize, as in the JAX
package.
"""
from __future__ import annotations

import os
import pickle
import random
import threading
from typing import Dict, List, Optional

import numpy as np
import PIL.Image

from . import native
from .flo import read_flo

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp")


def make_dataset(directory: str, recursive: bool = True) -> List[str]:
    """Recursive image-file scan, sorted. Follows directory symlinks but
    tracks visited realpaths, so cycles end and no sample repeats."""
    paths = []
    seen = set()
    for root, dirs, files in sorted(os.walk(directory, followlinks=True)):
        real = os.path.realpath(root)
        if real in seen:
            dirs[:] = []
            continue
        seen.add(real)
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(root, f))
        if not recursive:
            break
    return paths


class _RawFrameCache:
    """Bounded in-memory cache of raw decoded frames (before augmentation),
    keyed by realpath: every augmented view of a frame reuses its decode.
    Byte budget WALDO_FRAME_CACHE_MB (default 512, 0 disables), FIFO
    eviction; entries are read-only by convention (every consumer copies
    before it writes). The loader's threads share it: insertion and eviction
    hold a lock, the decode does not (at worst a frame decodes twice)."""

    def __init__(self):
        limit_mb = float(os.environ.get("WALDO_FRAME_CACHE_MB", "512"))
        self.limit = int(limit_mb * 1e6)
        self.store: Dict[str, np.ndarray] = {}
        self.bytes = 0
        self._lock = threading.Lock()

    def get(self, path: str, loader):
        path = os.path.realpath(path)
        arr = self.store.get(path)
        if arr is None:
            arr = loader(path)
            if self.limit > 0 and arr.nbytes < self.limit:
                with self._lock:
                    if path not in self.store:
                        while self.bytes + arr.nbytes > self.limit and self.store:
                            old = self.store.pop(next(iter(self.store)))
                            self.bytes -= old.nbytes
                        self.store[path] = arr
                        self.bytes += arr.nbytes
        return arr


_FRAME_CACHE = _RawFrameCache()


def _resize(arr: np.ndarray, size, method=PIL.Image.BILINEAR) -> np.ndarray:
    """Resize (H, W, C) float array channel by channel with Pillow."""
    h, w = size
    if arr.shape[:2] == (h, w):
        return arr
    chans = [np.asarray(PIL.Image.fromarray(arr[:, :, c], mode="F").resize((w, h), method))
             for c in range(arr.shape[2])]
    return np.stack(chans, axis=-1)


def _color_jitter(img: np.ndarray, brightness, contrast, saturation, hue) -> np.ndarray:
    """img (H, W, 3) in [0, 1]."""
    img = np.clip(img * brightness, 0, 1)
    if contrast != 1:
        mean = img.mean()
        img = np.clip(mean + contrast * (img - mean), 0, 1)
    if saturation != 1:
        gray = img.mean(axis=-1, keepdims=True)
        img = np.clip(gray + saturation * (img - gray), 0, 1)
    if hue != 0:
        hsv = np.asarray(PIL.Image.fromarray((img * 255).astype(np.uint8)).convert("HSV"),
                         dtype=np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(hue * 255)) % 256
        img = np.asarray(
            PIL.Image.fromarray(hsv.astype(np.uint8), mode="HSV").convert("RGB")
        ).astype(np.float32) / 255.0
    return img


class AugmentParams:
    def __init__(self, v_flip, h_flip, top_crop, left_crop, h_crop, w_crop, jitter, zoom):
        self.v_flip = v_flip
        self.h_flip = h_flip
        self.top_crop = top_crop
        self.left_crop = left_crop
        self.h_crop = h_crop
        self.w_crop = w_crop
        self.jitter = jitter
        self.zoom = zoom


class BaseVideoDataset:
    """Frame-folder video dataset with modality siblings."""

    def __init__(self, cfg, phase="train", rng: Optional[random.Random] = None,
                 fold: Optional[int] = None, num_folds: Optional[int] = None):
        self.cfg = cfg
        self.phase = phase
        self.rng = rng or random.Random(cfg.seed)
        self.dim = cfg.dim if cfg.load_dim == 0 else cfg.load_dim
        self.true_dim = cfg.true_dim
        self.true_ratio = getattr(cfg, "true_ratio", cfg.aspect_ratio)
        self.frame_folder = None
        self.layout_folder = None
        self.flow_folder = None
        # the clip-index cache: load_data skips the tree scan on reload
        data_path = self.serialized_path("data", phase, fold)
        if cfg.data.load_data and data_path and os.path.exists(data_path):
            with open(data_path, "rb") as f:
                blob = pickle.load(f)  # a file this program wrote
            self.data = blob["data"]
            self.frame_folder = blob.get("frame_folder")
            self.layout_folder = blob.get("layout_folder")
            self.flow_folder = blob.get("flow_folder")
        else:
            self.data = self.get_data(cfg, phase)
            if cfg.data.save_data and data_path:
                os.makedirs(os.path.dirname(data_path) or ".", exist_ok=True)
                with open(data_path, "wb") as f:
                    pickle.dump({"data": self.data, "frame_folder": self.frame_folder,
                                 "layout_folder": self.layout_folder,
                                 "flow_folder": self.flow_folder}, f)
        self._full_clips = self.data["vid_frame_paths"]
        self.num_folds = num_folds
        if num_folds:
            self.set_fold(fold or 0)

    def serialized_path(self, kind: str, phase: str, fold=None) -> Optional[str]:
        """Cache-file name under the data root."""
        d = self.cfg.data
        if not d.dataroot:
            return None
        specs = f"{d.data_specs}_" if d.data_specs else ""
        if fold is not None:
            return os.path.join(d.dataroot, "folds", f"{specs}{fold}_{phase}_{kind}.pkl")
        return os.path.join(d.dataroot, f"{specs}{phase}_{kind}.pkl")

    def set_fold(self, fold: int):
        """Select an interleaved shard of the clip index."""
        if not self.num_folds:
            raise ValueError("set_fold on a dataset made without num_folds")
        self.fold = fold % self.num_folds
        self.data = dict(self.data)
        self.data["vid_frame_paths"] = self._full_clips[self.fold:: self.num_folds]

    def get_data(self, cfg, phase) -> Dict:
        raise NotImplementedError

    def __len__(self):
        return len(self.data["vid_frame_paths"])

    # -- augmentation parameters --

    def sample_augmentation(self) -> AugmentParams:
        cfg = self.cfg
        d = cfg.data
        train = self.phase == "train"
        rnd = self.rng.random
        v_flip = rnd() > 0.5 if train and not d.no_v_flip else False
        h_flip = rnd() > 0.5 if train and not d.no_h_flip else False
        h = int(self.true_dim)
        w = int(self.true_dim * self.true_ratio)
        min_zoom = max(1.0, cfg.aspect_ratio / self.true_ratio)
        max_zoom = max(d.max_zoom, min_zoom)
        zoom = min_zoom + rnd() * (max_zoom - min_zoom) if train else min_zoom
        h_crop = int(h / zoom)
        w_crop = int(h_crop * cfg.aspect_ratio)
        top_crop = int(rnd() * (h - h_crop)) if train else 0
        left_crop = int(rnd() * (w - w_crop)) if train else 0
        jitter = None
        if d.colorjitter is not None and train:
            cj = d.colorjitter
            b = max(0, 1 + (rnd() * 2 - 1) * cj)
            c = 1 if d.colorjitter_no_contrast else max(0, 1 + (rnd() * 2 - 1) * cj)
            s = max(0, 1 + (rnd() * 2 - 1) * cj)
            hh = 0.5 * (rnd() * 2 - 1) * cj
            jitter = (b, c, s, hh)
        return AugmentParams(v_flip, h_flip, top_crop, left_crop, h_crop, w_crop, jitter, zoom)

    # -- per-modality loaders --

    def _out_size(self):
        return self.dim, int(self.dim * self.cfg.aspect_ratio)

    def _spatial(self, arr: np.ndarray, aug: AugmentParams) -> np.ndarray:
        """crop -> resize to (dim, dim*ar) -> flips, on (H, W, C) float."""
        a = arr[aug.top_crop: aug.top_crop + aug.h_crop,
                aug.left_crop: aug.left_crop + aug.w_crop]
        a = _resize(a, self._out_size())
        if aug.v_flip:  # v_flip mirrors left-right, as in the reference
            a = a[:, ::-1]
        if aug.h_flip:
            a = a[::-1]
        return np.ascontiguousarray(a)

    def rgb_from_array(self, raw: np.ndarray, aug: AugmentParams) -> np.ndarray:
        """uint8 (H, W, 3) -> augmented float (dim, dim*ar, 3) in [-1, 1],
        through Pillow (jitter and resize)."""
        img = raw.astype(np.float32) / 255.0
        if aug.jitter is not None:
            img = _color_jitter(img, *aug.jitter)
        img = self._spatial(img, aug)
        return img * 2.0 - 1.0

    def load_rgb(self, path: str, aug: AugmentParams) -> np.ndarray:
        raw = _FRAME_CACHE.get(path, lambda p: np.asarray(PIL.Image.open(p).convert("RGB")))
        if aug.jitter is not None:
            return self.rgb_from_array(raw, aug)
        h, w = self._out_size()
        return native.rgb_transform(raw, aug.top_crop, aug.left_crop, aug.h_crop, aug.w_crop,
                                    h, w, flip_x=aug.v_flip, flip_y=aug.h_flip)

    def load_layout(self, path: str, aug: AugmentParams) -> np.ndarray:
        d = self.cfg.data
        lyt = _FRAME_CACHE.get(path, lambda p: np.asarray(PIL.Image.open(p), np.int32))
        if lyt.ndim == 3:
            lyt = lyt[..., 0]
        h, w = self._out_size()
        return native.layout_onehot_resize(lyt, d.num_lyt, d.remap_lyt, aug.top_crop,
                                           aug.left_crop, aug.h_crop, aug.w_crop, h, w,
                                           flip_x=aug.v_flip, flip_y=aug.h_flip)

    def load_flow(self, path: str, aug: AugmentParams) -> np.ndarray:
        cfg = self.cfg
        flow = _FRAME_CACHE.get(path, read_flo)  # (H, W, 2) raw px
        h = flow.shape[0]
        # flow files may have their own resolution (flow_dim): crop in their
        # pixel space, scaled from true_dim coordinates
        fh_scale = h / self.true_dim
        top = int(aug.top_crop * fh_scale)
        left = int(aug.left_crop * fh_scale)
        chs = int((aug.top_crop + aug.h_crop) * fh_scale) - top
        cws = int((aug.left_crop + aug.w_crop) * fh_scale) - left
        fdim = cfg.flow_dim if cfg.flow_dim > 0 else cfg.dim
        return native.flow_normalize_resize(flow, aug.zoom, aug.v_flip, aug.h_flip, top, left,
                                            chs, cws, fdim, int(fdim * cfg.aspect_ratio))

    # -- clip assembly --

    def _select_frames(self, frame_paths: List[str]) -> List[str]:
        d = self.cfg.data
        if d.skip_first:
            frame_paths = frame_paths[1:]
        per_clip = d.load_vid_len if d.load_vid_len is not None else d.vid_len
        if len(frame_paths) < per_clip:
            raise ValueError(f"a clip of {len(frame_paths)} frames is shorter than {per_clip}")
        n = len(frame_paths) - (per_clip - 1) * d.one_every_n - 1
        idx = self.rng.randrange(n) if (self.phase == "train" and n > 0) else 0
        frame_paths = frame_paths[idx: idx + per_clip * d.one_every_n: d.one_every_n]
        if d.load_vid_len is not None:
            if d.load_n_plus_1:
                start = int(self.rng.random() * (d.load_vid_len - (d.vid_len - 1)))
                end = start + d.vid_len - 1
                last = int(self.rng.random() * (d.load_vid_len - end))
                frame_paths = frame_paths[start:end] + [frame_paths[end + last]]
            else:
                step = max(1, int(self.rng.random() * (d.load_vid_len - 1) / (d.vid_len - 1)))
                step = min(step, d.max_vid_step)
                start = int(self.rng.random() * (d.load_vid_len - (d.vid_len - 1) * step))
                frame_paths = frame_paths[start: start + step * (d.vid_len - 1) + 1: step]
        return frame_paths

    def draw(self, index: int):
        """The clip's draws from the shared stream: its augmentation, then
        its frames."""
        aug = self.sample_augmentation()
        return aug, self._select_frames(self.data["vid_frame_paths"][index])

    def make_clip(self, index: int, draws) -> Dict[str, np.ndarray]:
        """The clip made from ``draw(index)``; reads no shared random state."""
        d = self.cfg.data
        aug, frame_paths = draws
        out = {"path": frame_paths[0]}
        out["vid"] = np.stack([self.load_rgb(p, aug) for p in frame_paths])
        if d.load_lyt:
            lyt_paths = [p.replace(self.frame_folder, self.layout_folder) for p in frame_paths]
            out["lyt"] = np.stack([self.load_layout(p, aug) for p in lyt_paths])
        if d.load_flow:
            flow_paths = [p.replace(self.frame_folder, self.flow_folder).replace(".png", ".flo")
                          for p in frame_paths]
            out["flow"] = np.stack([self.load_flow(p, aug) for p in flow_paths])
        return out

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.make_clip(index, self.draw(index))
