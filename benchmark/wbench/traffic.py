"""The cells' inputs, made from a run's seed: scenes of smooth moving
content in the keys, shapes and value ranges of the port's loaders.

A scene is a drifting sinusoid texture over a two-class ground with a few
moving rectangles of other classes (the content ``chip_smoke.py``'s
``scene_frames`` writes as Cityscapes- and KITTI-format trees, here made
with torch on the device). A clip holds, channel-last in float32:

  vid  (T, H, W, 3)   in [-1, 1], quantized to 8-bit levels as a PNG frame is
  lyt  (T, H, W, Nl)  one-hot layouts scaled to {-5, 5}
  flow (T, Hf, Wf, 2) each frame's displacement from the frame before,
                      normalized 2 * px / width, 0 at the first frame

A mix's file gives the scenes' parameters (``scene``) and the pool: how
many distinct batches a run makes at set-up and cycles through.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def _draws(seed: int, index: int, num_lyt: int, p: dict) -> dict:
    """The parameters of scene ``index`` of a run seeded ``seed``."""
    rng = np.random.default_rng([seed, index])
    n_obj = int(rng.integers(p["objects"][0], p["objects"][1] + 1))
    return dict(
        freq=rng.random(4) * p["freq"][1] + p["freq"][0],
        phase=rng.random(4) * 2 * math.pi,
        slope=rng.random(4) * 2 - 1,
        amp=rng.random((4, 3)) * p["amp"],
        vel=rng.standard_normal(2) * p["bg_speed"],
        objs=[dict(c=rng.random(2), v=rng.standard_normal(2) * p["obj_speed"],
                   half=rng.random(2) * (p["obj_half"][1] - p["obj_half"][0]) + p["obj_half"][0],
                   rgb=rng.random(3) * 255, cls=int(rng.integers(2, num_lyt)))
              for _ in range(n_obj)],
    )


def scene(seed: int, index: int, t: int, hw, fhw, num_lyt: int, params: dict,
          device) -> Dict[str, torch.Tensor]:
    """One clip of T frames at hw = (H, W) with flows at fhw = (Hf, Wf).
    Speeds and sizes are shares of the frame, so one seed gives the same
    scene at any size."""
    d = _draws(seed, index, num_lyt, params)
    h, w = hw
    fh, fw = fhw
    f32 = dict(dtype=torch.float32, device=device)
    yy = torch.linspace(0, 1, h, **f32)[:, None].expand(h, w)
    xx = torch.linspace(0, 1, w, **f32)[None, :].expand(h, w)
    fy = torch.linspace(0, 1, fh, **f32)[:, None].expand(fh, fw)
    fx = torch.linspace(0, 1, fw, **f32)[None, :].expand(fh, fw)
    k = torch.arange(t, **f32)[:, None, None]  # frame index
    vel = torch.tensor(d["vel"], **f32)
    ox, oy = vel[0] * k, vel[1] * k
    tex = torch.zeros((t, h, w, 3), **f32)
    for i in range(4):
        wave = torch.sin(float(d["freq"][i]) * ((xx + ox) + float(d["slope"][i]) * (yy + oy))
                         + float(d["phase"][i]))
        tex += wave[..., None] * torch.tensor(d["amp"][i], **f32)
    img = (0.5 + tex) * 255
    lab = (yy <= 0.55).long().expand(t, h, w).clone()  # ground 0, sky 1
    flow = (-2 * vel).expand(t, fh, fw, 2).clone()
    for o in d["objs"]:
        c, v, half = (torch.tensor(o[x], **f32) for x in ("c", "v", "half"))
        cx, cy = c[0] + v[0] * k, c[1] + v[1] * k
        m = ((xx - cx).abs() < half[0]) & ((yy - cy).abs() < half[1])
        img = torch.where(m[..., None], torch.tensor(o["rgb"], **f32), img)
        lab = torch.where(m, o["cls"], lab)
        mf = ((fx - cx).abs() < half[0]) & ((fy - cy).abs() < half[1])
        flow = torch.where(mf[..., None], -2 * v, flow)
    flow[0] = 0
    vid = img.clamp(0, 255).round() / 255 * 2 - 1
    lyt = torch.nn.functional.one_hot(lab, num_lyt).float() * 10 - 5
    return {"vid": vid, "lyt": lyt, "flow": flow}


def batches(cfg, traffic: dict, seed: int, device, host: bool) -> List[Dict[str, object]]:
    """The run's pool: ``traffic["pool"]`` batches of ``cfg.batch_size_vid``
    distinct clips at the configuration's geometry, scene index = batch *
    B + row. Evaluation batches load at ``load_dim`` with flows at
    ``flow_dim``; ``host`` gives them as numpy arrays, as the loader hands
    them to the evaluator, else as device tensors."""
    dim = cfg.load_dim if (traffic["loop"] == "eval" and cfg.load_dim > 0) else cfg.dim
    fdim = cfg.flow_dim if cfg.flow_dim > 0 else cfg.dim
    hw = (dim, int(dim * cfg.aspect_ratio))
    fhw = (fdim, int(fdim * cfg.aspect_ratio))
    b, t, nl = cfg.batch_size_vid, cfg.data.vid_len, cfg.data.num_lyt
    pool = []
    for j in range(traffic["pool"]):
        clips = [scene(seed, j * b + r, t, hw, fhw, nl, traffic["scene"], device)
                 for r in range(b)]
        batch = {k: torch.stack([c[k] for c in clips]) for k in ("vid", "lyt", "flow")}
        if host:
            batch = {k: v.cpu().numpy() for k, v in batch.items()}
        pool.append(batch)
    return pool
