"""I3D (Inflated Inception-V1) video features for true FVD (counterpart of
waldo_tpu/eval/i3d.py).

The FVD protocol (Unterthiner et al.) embeds videos with a Kinetics-400
I3D and takes the Frechet distance over its logits or pre-logits. The
standard pytorch-i3d layout (Conv3d_1a .. Mixed_5c) with TF "SAME" padding
and BatchNorm folded into each convolution, as the JAX package's flax
module has them. "SAME" pads a strided convolution or pool asymmetrically
(the extra pixel at the end); the port pads explicitly: zeros before a
convolution, -inf before a max pool. Channel-last at the boundary.

Weights: ``I3DExtractor.maybe_load`` reads the JAX package's ``.npz``
(``$WALDO_I3D_WEIGHTS/i3d_kinetics400.npz``) through
``waldo_tpu_torch.convert.i3d_from_jax``; none are in the repository and
none are fetched. Without them the metrics CLI falls back to Inception's
'rfvd_proxy'; ``random_extractor`` is a seeded random I3D ('rfvd', relative
comparisons only, and not the JAX package's random weights).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import resolve_device
from .inception import init_random

# (b0, b1a, b1b, b2a, b2b, b3b) per inception module
_MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}


def _same_pad(x, kernel, strides, value):
    """Pad (B, C, T, H, W) as TF "SAME" does for a window ``kernel`` moved
    by ``strides``: total max((ceil(n/s) - 1) s + k - n, 0) per axis, the
    larger half at the end."""
    pads = []
    for n, k, s in zip(x.shape[2:], kernel, strides):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last axis first
    return F.pad(x, flat, value=value) if any(flat) else x


class Unit3D(nn.Module):
    """conv3d + (folded) bias + relu, with "SAME" padding."""

    def __init__(self, cin, features, kernel: Sequence[int] = (1, 1, 1),
                 strides: Sequence[int] = (1, 1, 1), relu: bool = True):
        super().__init__()
        self.kernel, self.strides, self.relu = tuple(kernel), tuple(strides), relu
        self.conv3d = nn.Conv3d(cin, features, self.kernel, stride=self.strides)

    def forward(self, x):
        x = self.conv3d(_same_pad(x, self.kernel, self.strides, 0.0))
        return F.relu(x) if self.relu else x


def _maxpool3d(x, kernel, strides):
    return F.max_pool3d(_same_pad(x, kernel, strides, float("-inf")), kernel, strides)


class InceptionModule(nn.Module):
    def __init__(self, cin, specs: Sequence[int]):
        super().__init__()
        s = specs
        self.b0 = Unit3D(cin, s[0])
        self.b1a = Unit3D(cin, s[1])
        self.b1b = Unit3D(s[1], s[2], (3, 3, 3))
        self.b2a = Unit3D(cin, s[3])
        self.b2b = Unit3D(s[3], s[4], (3, 3, 3))
        self.b3b = Unit3D(cin, s[5])

    def forward(self, x):
        b3 = self.b3b(_maxpool3d(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], dim=1)


class I3D(nn.Module):
    """x (B, T, H, W, 3) in [-1, 1] -> dict(logits (B,400), features (B,1024))."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, s in _MIXED.items():
            setattr(self, name, InceptionModule(cin, s))
            cin = s[0] + s[2] + s[4] + s[5]
        self.logits = Unit3D(cin, num_classes, relu=False)

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3)
        x = self.Conv3d_1a_7x7(x)
        x = _maxpool3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = _maxpool3d(x, (1, 3, 3), (1, 2, 2))
        for name in ("Mixed_3b", "Mixed_3c"):
            x = getattr(self, name)(x)
        x = _maxpool3d(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = _maxpool3d(x, (2, 2, 2), (2, 2, 2))
        for name in ("Mixed_5b", "Mixed_5c"):
            x = getattr(self, name)(x)
        pooled = x.mean(dim=(2, 3, 4), keepdim=True)
        logits = self.logits(pooled)
        return {"features": pooled.flatten(1), "logits": logits.flatten(1)}


class I3DExtractor:
    """(B, T, H, W, 3) videos in [0, 1] (numpy) -> FVD embeddings (B, D)
    numpy, computed on ``device``; ``layer`` "logits" or "features"."""

    name = "i3d"

    def __init__(self, module: I3D, layer: str = "logits", device="cuda"):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.layer = layer

    @torch.no_grad()
    def __call__(self, vids):
        x = torch.from_numpy(np.asarray(vids, np.float32)).to(self.device)
        return self.module(x * 2.0 - 1.0)[self.layer].cpu().numpy()  # I3D takes [-1, 1]

    @staticmethod
    def weights_path():
        root = os.environ.get("WALDO_I3D_WEIGHTS", os.path.expanduser("~/.cache/waldo"))
        return os.path.join(root, "i3d_kinetics400.npz")

    @classmethod
    def maybe_load(cls, layer: str = "logits", device="cuda") -> Optional["I3DExtractor"]:
        path = cls.weights_path()
        if not os.path.exists(path):
            return None
        from ..convert import i3d_from_jax

        module = I3D()
        i3d_from_jax(np.load(path, allow_pickle=True)["params"].item(), module)
        return cls(module, layer=layer, device=device)


def random_extractor(seed: int = 0, layer: str = "features", device="cuda") -> I3DExtractor:
    """Seeded random-init I3D, for relative comparisons only ('rfvd')."""
    ex = I3DExtractor(init_random(I3D(), seed), layer=layer, device=device)
    ex.name = "rfvd"
    return ex


# ---------------------------------------------------------------------------
# pytorch-i3d state-dict conversion (BN folded into the conv's kernel and bias)
# ---------------------------------------------------------------------------

_UNITS = (
    ["Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"]
    + [f"{m}.{b}" for m in _MIXED for b in ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")]
)


def convert_i3d_state_dict(sd, bn_eps: float = 1e-3) -> dict:
    """pytorch-i3d names (`X.conv3d.weight`, `X.bn.{weight,bias,running_*}`)
    -> the JAX package's flax tree (numpy) with BatchNorm folded into the
    conv kernel and bias, which ``maybe_load`` reads."""
    def npy(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)

    def fold(prefix):
        w = npy(sd[f"{prefix}.conv3d.weight"])  # (O, I, kt, kh, kw)
        gamma = npy(sd[f"{prefix}.bn.weight"])
        beta = npy(sd[f"{prefix}.bn.bias"])
        mean = npy(sd[f"{prefix}.bn.running_mean"])
        var = npy(sd[f"{prefix}.bn.running_var"])
        scale = gamma / np.sqrt(var + bn_eps)
        kernel = (w * scale[:, None, None, None, None]).transpose(2, 3, 4, 1, 0)
        bias = beta - mean * scale
        return {"kernel": np.ascontiguousarray(kernel, np.float32),
                "bias": bias.astype(np.float32)}

    tree: dict = {}
    for unit in _UNITS:
        parts = unit.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node.setdefault(parts[-1], {})["conv3d"] = fold(unit)
    # the logits conv has a real bias and no BN
    w = npy(sd["logits.conv3d.weight"]).transpose(2, 3, 4, 1, 0)
    tree["logits"] = {"conv3d": {
        "kernel": np.ascontiguousarray(w, np.float32),
        "bias": npy(sd["logits.conv3d.bias"]).astype(np.float32)}}
    return tree


def convert_i3d_weights(out_path: str, state_dict) -> str:
    """Write ``convert_i3d_state_dict(state_dict)`` as the ``.npz`` that
    ``maybe_load`` reads, after loading it into an I3D (which checks every
    path and shape)."""
    from ..convert import i3d_from_jax

    tree = convert_i3d_state_dict(state_dict)
    i3d_from_jax(tree, I3D())
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, params=np.asarray(tree, dtype=object))
    return out_path


def fvd(extractor, real_vids, fake_vids, batch: int = 8):
    """True FVD when ``extractor`` is an I3DExtractor with converted weights;
    vids: list/array of (T, H, W, 3) in [0, 1]."""
    from .frechet import frechet_distance_from_acts

    def acts(vids):
        vids = np.stack([np.asarray(v) for v in vids])
        out = []
        for i in range(0, len(vids), batch):
            out.append(np.asarray(extractor(vids[i: i + batch])))
        return np.concatenate(out)

    return frechet_distance_from_acts(acts(real_vids), acts(fake_vids))
