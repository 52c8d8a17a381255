"""LPIPS perceptual distance (the port's copy of waldo_tpu/eval/lpips.py):
net-lin over AlexNet (the metric) or VGG16 (WIF's training loss).

The weights are the JAX package's ``.npz`` (``conv{i}_kernel`` (kh,kw,I,O),
``conv{i}_bias``, ``lin{i}``), so one file serves both packages. They are
not in the repo and nothing here fetches them: ``convert_lpips_state_dict``
turns the torch ``lpips`` package's state dict into that file where the
package is at hand, and ``LPIPS.maybe_load`` reads it from
``$WALDO_LPIPS_WEIGHTS`` (default ``checkpoints/lpips``) or returns None.

Channel-last at its public face: ``LPIPS()(a, b)`` takes (..., H, W, 3) in
[-1, 1] and returns (...,) distances; the nets run channel-first inside.
Max pools take flax's VALID windows (no padding, floor).
"""
from __future__ import annotations

import os
import re
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import resolve_device

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

ALEX_SPEC = [  # (features, kernel, stride, pad, pool_before)
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]

VGG16_SPEC = [2, 2, 3, 3, 3]  # conv counts per slice, 64*2^i channels (max 512)


class AlexFeatures(nn.Module):
    """(N, 3, H, W) -> the five ReLU outputs, channel-first."""

    def __init__(self):
        super().__init__()
        chans = [3] + [f for f, *_ in ALEX_SPEC]
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], f, k, stride=s, padding=p)
            for i, (f, k, s, p, _) in enumerate(ALEX_SPEC))

    def forward(self, x):
        feats = []
        for conv, (*_, pool) in zip(self.convs, ALEX_SPEC):
            if pool:
                x = F.max_pool2d(x, 3, stride=2)
            x = F.relu(conv(x))
            feats.append(x)
        return feats


class VGG16Features(nn.Module):
    """(N, 3, H, W) -> the last ReLU output of each of the five slices."""

    def __init__(self):
        super().__init__()
        convs, ch_in = [], 3
        for slice_i, n_convs in enumerate(VGG16_SPEC):
            ch = min(64 * (2 ** slice_i), 512)
            for _ in range(n_convs):
                convs.append(nn.Conv2d(ch_in, ch, 3, padding=1))
                ch_in = ch
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        feats, idx = [], 0
        for slice_i, n_convs in enumerate(VGG16_SPEC):
            for _ in range(n_convs):
                x = F.relu(self.convs[idx](x))
                idx += 1
            feats.append(x)
            if slice_i < len(VGG16_SPEC) - 1:
                x = F.max_pool2d(x, 2, stride=2)
        return feats


def _normalize_feat(f, eps=1e-10):
    return f / torch.sqrt((f ** 2).sum(1, keepdim=True) + eps)


class LPIPS(nn.Module):
    """lpips(a, b): a, b (..., H, W, 3) in [-1, 1] -> (...,) distances. Its
    parameters are frozen: a gradient reaches the inputs only."""

    def __init__(self, net: str, convs: Sequence, lin_weights: Sequence[np.ndarray],
                 device="cuda"):
        """``convs``: (kernel (kh,kw,I,O), bias) numpy pairs in the nets'
        order, ``lin_weights``: the five per-channel weight vectors."""
        super().__init__()
        dev = resolve_device(device)
        self.features = AlexFeatures() if net == "alex" else VGG16Features()
        if len(convs) != len(self.features.convs) or len(lin_weights) != 5:
            raise ValueError(f"LPIPS {net!r} takes {len(self.features.convs)} convolutions and "
                             f"5 lin heads, got {len(convs)} and {len(lin_weights)}")
        with torch.no_grad():
            for conv, (kernel, bias) in zip(self.features.convs, convs):
                conv.weight.copy_(torch.from_numpy(np.asarray(kernel).transpose(3, 2, 0, 1)))
                conv.bias.copy_(torch.from_numpy(np.asarray(bias)))
        self.lin = nn.ParameterList(
            nn.Parameter(torch.from_numpy(np.asarray(w, np.float32)).reshape(1, -1, 1, 1))
            for w in lin_weights)
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1))
        self.requires_grad_(False)
        self.to(dev).eval()

    def forward(self, a, b):
        lead = tuple(a.shape[:-3])
        prep = lambda v: (v.reshape((-1,) + tuple(v.shape[-3:])).permute(0, 3, 1, 2).float()
                          - self.shift) / self.scale
        fa, fb = self.features(prep(a)), self.features(prep(b))
        dist = 0.0
        for f1, f2, w in zip(fa, fb, self.lin):
            d = (_normalize_feat(f1) - _normalize_feat(f2)) ** 2
            dist = dist + (d * w).sum(1).mean(dim=(1, 2))
        return dist.reshape(lead)

    @staticmethod
    def weights_path(net="alex"):
        root = os.environ.get("WALDO_LPIPS_WEIGHTS", "checkpoints/lpips")
        return os.path.join(root, f"lpips_{net}.npz")

    @classmethod
    def maybe_load(cls, net="alex", device="cuda") -> Optional["LPIPS"]:
        """The net from its weights file on ``device``, or None without one."""
        path = cls.weights_path(net)
        if not os.path.exists(path):
            return None
        n_conv = len(ALEX_SPEC) if net == "alex" else sum(VGG16_SPEC)
        with np.load(path) as data:
            convs = [(data[f"conv{i}_kernel"], data[f"conv{i}_bias"]) for i in range(n_conv)]
            lin = [data[f"lin{i}"] for i in range(5)]
        return cls(net, convs, lin, device=device)


def convert_lpips_state_dict(state_dict) -> dict:
    """The torch ``lpips`` package's flat state dict -> the npz arrays.

    Keys (the lpips package layout): ``net.slice{k}.{idx}.weight/bias`` for
    the backbone convolutions (torchvision's indices within each slice) and
    ``lin{i}.model.1.weight`` (1x1 conv) for the linear heads. A conv weight
    (O,I,kh,kw) becomes a flax kernel (kh,kw,I,O), a lin head a vector."""
    def npy(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)

    conv_pat = re.compile(r"^net\.slice(\d+)\.(\d+)\.weight$")
    convs = sorted((int(m.group(1)), int(m.group(2)), k)
                   for k in state_dict if (m := conv_pat.match(k)))
    arrays = {}
    for i, (_, _, k) in enumerate(convs):
        w = npy(state_dict[k])
        if w.ndim != 4:
            raise ValueError(f"{k}: a conv weight is 4-d, got shape {w.shape}")
        arrays[f"conv{i}_kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        arrays[f"conv{i}_bias"] = npy(state_dict[k[:-len("weight")] + "bias"])
    i = 0
    while f"lin{i}.model.1.weight" in state_dict:
        arrays[f"lin{i}"] = npy(state_dict[f"lin{i}.model.1.weight"]).reshape(-1)
        i += 1
    if i != 5:
        raise ValueError(f"expected 5 lin heads, got {i}")
    return arrays
