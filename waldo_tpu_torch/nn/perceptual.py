"""VGG19 perceptual loss (counterpart of waldo_tpu/nn/perceptual.py): the
feature L1 of the five taps relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1
of torchvision's vgg19.features (after convolutions 0, 2, 4, 8 and 12),
weighted [1/32, 1/16, 1/8, 1/4, 1], the target's features detached.

Channel-last at its public face: ``VGGLoss()(x, y)`` takes (..., H, W, 3)
(as given, no input normalization, as in the JAX package) and returns a
scalar; the net runs channel-first inside. Max pools take 2x2 VALID windows
(floor), as flax's ``max_pool``.

The weights are the JAX package's ``vgg19_features.npz`` (``conv{i}_kernel``
(kh, kw, I, O), ``conv{i}_bias``), so one file serves both packages. They
are not in the repo and nothing here fetches them: ``convert_vgg19_weights``
writes the file from a torchvision state dict (or its ``.pth``) that the
caller has, and ``VGGLoss.maybe_load`` reads it from ``$WALDO_VGG_WEIGHTS``
(default ``checkpoints/vgg``) or returns None. A flax tree of the JAX
``VGG19Features`` loads with ``waldo_tpu_torch.convert.vgg19_from_jax``.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import resolve_device

# torchvision vgg19.features through relu5_1: 13 convs, "P" = 2x2 max pool
_VGG19_LAYOUT = [64, 64, "P", 128, 128, "P", 256, 256, 256, 256, "P",
                 512, 512, 512, 512, "P", 512]
_TAPS = (0, 2, 4, 8, 12)
# the convolutions' indices in torchvision's features Sequential
VGG19_TORCH_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28]
_WEIGHTS = [1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0]


class VGG19Features(nn.Module):
    """(N, 3, H, W) -> the five tapped ReLU outputs, channel-first. The
    convolutions are ``conv0`` ... ``conv12`` (weights (O, I, 3, 3)), the
    JAX package's names."""

    def __init__(self):
        super().__init__()
        ch_in, i = 3, 0
        for item in _VGG19_LAYOUT:
            if item == "P":
                continue
            self.add_module(f"conv{i}", nn.Conv2d(ch_in, item, 3, padding=1))
            ch_in, i = item, i + 1
        self.num_convs = i

    def forward(self, x):
        feats, i = [], 0
        for item in _VGG19_LAYOUT:
            if item == "P":
                x = F.max_pool2d(x, 2, stride=2)
                continue
            conv = getattr(self, f"conv{i}")
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
            if i in _TAPS:
                feats.append(x)
            i += 1
        return feats


class VGGLoss(nn.Module):
    """loss(x, y): x, y (..., H, W, 3) -> the weighted feature L1, a 0-d
    tensor; a gradient reaches x only. Its parameters are frozen."""

    def __init__(self, convs: Sequence, device="cuda"):
        """``convs``: the 13 (kernel (kh, kw, I, O), bias) numpy pairs."""
        super().__init__()
        self.features = VGG19Features()
        if len(convs) != self.features.num_convs:
            raise ValueError(f"VGG19 takes {self.features.num_convs} convolutions, got "
                             f"{len(convs)}")
        with torch.no_grad():
            for i, (kernel, bias) in enumerate(convs):
                conv = getattr(self.features, f"conv{i}")
                conv.weight.copy_(torch.from_numpy(np.asarray(kernel, np.float32)
                                                   .transpose(3, 2, 0, 1)))
                conv.bias.copy_(torch.from_numpy(np.asarray(bias, np.float32)))
        self.requires_grad_(False)
        self.to(resolve_device(device)).eval()

    def forward(self, x, y):
        prep = lambda v: v.reshape((-1,) + tuple(v.shape[-3:])).permute(0, 3, 1, 2).float()
        fx = self.features(prep(x))
        with torch.no_grad():
            fy = self.features(prep(y))
        loss = 0.0
        for w, a, b in zip(_WEIGHTS, fx, fy):
            loss = loss + w * (a - b).abs().mean()
        return loss

    @staticmethod
    def weights_path() -> str:
        root = os.environ.get("WALDO_VGG_WEIGHTS", "checkpoints/vgg")
        return os.path.join(root, "vgg19_features.npz")

    @classmethod
    def maybe_load(cls, device="cuda") -> Optional["VGGLoss"]:
        """The loss from its weights file on ``device``, or None without one."""
        path = cls.weights_path()
        if not os.path.exists(path):
            return None
        with np.load(path) as data:
            n = sum(1 for item in _VGG19_LAYOUT if item != "P")
            convs = [(data[f"conv{i}_kernel"], data[f"conv{i}_bias"]) for i in range(n)]
        return cls(convs, device=device)


def convert_vgg19_state_dict(state_dict) -> dict:
    """torchvision vgg19's ``features.<i>.weight/bias`` (torch tensors or
    numpy arrays) -> the npz arrays: the 13 convolutions through relu5_1, a
    weight (O, I, kh, kw) as a flax kernel (kh, kw, I, O). Raises KeyError
    naming a missing entry."""
    def npy(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)

    arrays = {}
    for i, idx in enumerate(VGG19_TORCH_CONV_IDX):
        for leaf in ("weight", "bias"):
            if f"features.{idx}.{leaf}" not in state_dict:
                raise KeyError(f"the VGG19 state dict has no features.{idx}.{leaf}")
        w = npy(state_dict[f"features.{idx}.weight"])
        arrays[f"conv{i}_kernel"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
        arrays[f"conv{i}_bias"] = npy(state_dict[f"features.{idx}.bias"])
    return arrays


def convert_vgg19_weights(out_path: str, state_dict=None) -> str:
    """Writes ``out_path`` (the npz ``VGGLoss.maybe_load`` reads) from
    torchvision vgg19's state dict, or from the path of its ``.pth``. It
    never downloads: without a state dict, or with a path that does not
    exist, it raises FileNotFoundError naming the file it lacks."""
    if state_dict is None or isinstance(state_dict, (str, os.PathLike)):
        path = state_dict
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(
                f"no VGG19 weights: {path or 'torchvision vgg19 state dict (vgg19-dcbb9e9d.pth)'} "
                "is missing; pass torchvision's vgg19 state dict or the path of its .pth "
                "(nothing is downloaded)")
        state_dict = torch.load(path, map_location="cpu", weights_only=True)
    arrays = convert_vgg19_state_dict(state_dict)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, **arrays)
    return out_path
