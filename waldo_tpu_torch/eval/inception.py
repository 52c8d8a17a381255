"""InceptionV3 pool3 features for FID (counterpart of
waldo_tpu/eval/inception.py).

torchvision's ``inception_v3`` through ``avgpool`` (the 2048-d pool3
activations pytorch-fid uses), with each BasicConv2d's BatchNorm folded into
its convolution (w' = w * g / sqrt(var + eps), b' = beta - mean * g /
sqrt(var + eps)): conv + bias + relu blocks under torchvision's names.
Channel-last at the boundary, as the JAX module is.

Weights: ``InceptionExtractor.maybe_load`` reads the JAX package's ``.npz``
(``$WALDO_INCEPTION_WEIGHTS/inception_v3_features.npz``, a pickled flax
tree) through ``waldo_tpu_torch.convert.inception_from_jax``; none are in
the repository and none are fetched. Without them callers may fall back to
``random_extractor``, a seeded random-init network named "rfid": its
distances serve RELATIVE comparisons only, and its weights are not the JAX
package's random ones, so its values differ from JAX's "rfid".

Images are resized to 299x299 as ``jax.image.resize(..., "bilinear")``
does: a triangle kernel widened by the scale when it downscales (an
antialiasing filter, unlike ``F.interpolate``), one small matrix per axis.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils import resolve_device


class BasicConv(nn.Module):
    """torchvision's BasicConv2d with its BN folded in at conversion."""

    def __init__(self, cin, features, kernel, stride=1, padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride=stride, padding=padding)

    def forward(self, x):
        return F.relu(self.conv(x))


def _avgpool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _maxpool3(x):
    return F.max_pool2d(x, 3, stride=2)  # flax max_pool pads nothing


class InceptionA(nn.Module):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=(1, 1))
        self.branch_pool = BasicConv(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _maxpool3(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin, c7):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avgpool3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, _maxpool3(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_avgpool3(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3Features(nn.Module):
    """x (B, H, W, 3) in [-1, 1] (299x299 for FID; 75 px or more) -> pool3
    activations (B, 2048)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool3(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _maxpool3(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive avgpool -> (B, 2048)


# ---------------------------------------------------------------------------
# the resize of jax.image.resize(..., "bilinear")
# ---------------------------------------------------------------------------


def resize_weights(input_size: int, output_size: int) -> np.ndarray:
    """(output_size, input_size) float32 weights of one axis of
    ``jax.image.resize(..., "bilinear")`` (its ``compute_weight_mat`` with
    the triangle kernel, antialiased: widened by 1/scale when it
    downscales), in the float32 arithmetic XLA compiles it to."""
    scale = output_size / input_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(inv_scale, np.float32(1.0))
    # XLA fuses the sample position's product and difference into one
    # multiply-add, rounded once: exact in float64, then rounded to float32
    sample_f = ((np.arange(output_size, dtype=np.float64) + 0.5) * np.float64(inv_scale)
                - 0.5).astype(np.float32)
    x = np.abs(sample_f[None, :] - np.arange(input_size, dtype=np.float32)[:, None]) \
        / kernel_scale
    weights = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], weights, np.float32(0)).T,
                                dtype=np.float32)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """x (B, H, W, C) float32 -> (B, height, width, C), as
    ``jax.image.resize(x, (B, height, width, C), "bilinear")``; an axis of
    equal size is left as it is."""
    if x.shape[1] != height:
        wh = torch.from_numpy(resize_weights(x.shape[1], height)).to(x.device)
        x = torch.einsum("oh,bhwc->bowc", wh, x)
    if x.shape[2] != width:
        ww = torch.from_numpy(resize_weights(x.shape[2], width)).to(x.device)
        x = torch.einsum("ow,bhwc->bhoc", ww, x)
    return x


# ---------------------------------------------------------------------------
# extractors
# ---------------------------------------------------------------------------


class InceptionExtractor:
    """images (B,H,W,3) in [0,1] (numpy) -> (B, 2048) numpy, computed on
    ``device``; resizes to 299 like pytorch-fid."""

    name = "fid"

    def __init__(self, module: InceptionV3Features, device="cuda"):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, imgs):
        x = torch.from_numpy(np.asarray(imgs, np.float32)).to(self.device)
        if tuple(x.shape[1:3]) != (299, 299):
            x = resize_bilinear(x, 299, 299)
        return self.module(x * 2.0 - 1.0).cpu().numpy()

    @staticmethod
    def weights_path():
        root = os.environ.get("WALDO_INCEPTION_WEIGHTS", "checkpoints/inception")
        return os.path.join(root, "inception_v3_features.npz")

    @classmethod
    def maybe_load(cls, device="cuda") -> Optional["InceptionExtractor"]:
        path = cls.weights_path()
        if not os.path.exists(path):
            return None
        from ..convert import inception_from_jax

        module = InceptionV3Features()
        inception_from_jax(np.load(path, allow_pickle=True)["params"].item(), module)
        return cls(module, device=device)


def init_random(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random conv weights (flax's default law: normal with variance
    1/fan_in, truncated at 2 standard deviations), zero biases."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                fan_in = m.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.randn(m.weight.shape, generator=gen).clamp_(-2, 2) * std
                m.weight.copy_(w)
                m.bias.zero_()
    return module


def random_extractor(seed: int = 0, device="cuda") -> InceptionExtractor:
    """Seeded random-init extractor, for relative comparisons only ('rfid');
    its weights are not the JAX package's random ones."""
    ex = InceptionExtractor(init_random(InceptionV3Features(), seed), device=device)
    ex.name = "rfid"
    return ex


# ---------------------------------------------------------------------------
# conversion of torchvision weights (run where they exist, or pass a state dict)
# ---------------------------------------------------------------------------


def convert_inception_state_dict(state_dict) -> dict:
    """torchvision inception_v3 state dict -> the JAX package's flax tree
    with BN folded (numpy arrays), which ``maybe_load`` reads.

    Keys look like `Mixed_5b.branch1x1.conv.weight` + `...bn.{weight,bias,
    running_mean,running_var}`; fc and AuxLogits are ignored."""
    def npy(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)

    tree = {}
    n = 0
    for key in state_dict:
        if not key.endswith(".conv.weight") or key.startswith("AuxLogits"):
            continue
        base = key[: -len(".conv.weight")]
        w = npy(state_dict[key]).astype(np.float64)  # (O,I,kh,kw)
        g = npy(state_dict[base + ".bn.weight"]).astype(np.float64)
        beta = npy(state_dict[base + ".bn.bias"]).astype(np.float64)
        mean = npy(state_dict[base + ".bn.running_mean"]).astype(np.float64)
        var = npy(state_dict[base + ".bn.running_var"]).astype(np.float64)
        scale = g / np.sqrt(var + 1e-3)  # torchvision BasicConv2d bn eps
        w = w * scale[:, None, None, None]
        b = beta - mean * scale
        node = tree.setdefault("params", {})
        for p in base.split("."):
            node = node.setdefault(p, {})
        node["conv"] = {
            "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)).astype(np.float32),
            "bias": b.astype(np.float32),
        }
        n += 1
    if n != 94:
        raise ValueError(f"expected 94 folded convs, got {n}")
    return tree


def convert_inception_weights(out_path: str, state_dict) -> str:
    """Write ``convert_inception_state_dict(state_dict)`` as the ``.npz``
    that ``maybe_load`` reads (the JAX package's layout)."""
    tree = convert_inception_state_dict(state_dict)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez(out_path, params=np.asarray(tree, dtype=object))
    return out_path
