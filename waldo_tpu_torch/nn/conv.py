"""Convolutional modules: UNet (WIF fusion) and ConvPatchProj (patch codec)
(counterpart of waldo_tpu/nn/conv.py).

Public forwards take and return channel-last tensors like the JAX package;
inside, the stacks run channel-first as ``F.conv2d`` wants. The transposed
conv is torch's ``ConvTranspose2d(3, stride=2, padding=1,
output_padding=1)``, whose taps are the spatial flip of the JAX package's
``lax.conv_transpose`` kernel (convert.py flips them when it loads one).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .init import resolve_dtype, xavier_uniform_
from .transform import CustomNorm


class _Conv(nn.Module):
    """3x3 conv (stride 1 or 2, padding 1) or 3x3 stride-2 transposed conv,
    no bias, float32 parameters, computed in ``dtype`` on channel-first
    input."""

    def __init__(self, in_ch, out_ch, stride=1, transpose=False, dtype=torch.float32,
                 zero_init=False):
        super().__init__()
        shape = (in_ch, out_ch, 3, 3) if transpose else (out_ch, in_ch, 3, 3)
        self.weight = nn.Parameter(torch.empty(shape))
        self.stride = 2 if transpose else stride
        self.transpose = transpose
        self.dtype = resolve_dtype(dtype)
        self.zero_init = zero_init

    def init_parameters(self, generator):
        if self.zero_init:
            self.weight.zero_()
        else:
            xavier_uniform_(self.weight, generator)

    def forward(self, x):
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if self.transpose:
            return F.conv_transpose2d(x, w, stride=2, padding=1, output_padding=1)
        return F.conv2d(x, w, stride=self.stride, padding=1)


def conv3x3(in_ch, out_ch, dtype=torch.float32, zero_init=False):
    return _Conv(in_ch, out_ch, 1, dtype=dtype, zero_init=zero_init)


def conv_down(in_ch, out_ch, dtype=torch.float32):
    return _Conv(in_ch, out_ch, 2, dtype=dtype)


def deconv_up(in_ch, out_ch, dtype=torch.float32, zero_init=False):
    return _Conv(in_ch, out_ch, transpose=True, dtype=dtype, zero_init=zero_init)


class ConvBlock(nn.Module):
    """conv_down or deconv_up, then norm and exact GELU (channel-first)."""

    def __init__(self, in_ch, out_ch, mode, norm_layer, dtype=torch.float32):
        super().__init__()
        self.conv = (conv_down if mode == "conv" else deconv_up)(in_ch, out_ch, dtype=dtype)
        self.norm = CustomNorm(norm_layer, out_ch)

    def forward(self, x):
        return F.gelu(self.norm.forward_nchw(self.conv(x)))


class UNet(nn.Module):
    """Stride-2 conv/deconv UNet with skip concat. (B,H,W,Cin) -> (B,H,W,Cout).
    ``deconv_layers`` are stored in the order they run."""

    def __init__(self, in_channels, num_channels_out, embed_dim, norm_layer, depth,
                 zero_init=False, dtype=torch.float32):
        super().__init__()
        planes = [embed_dim // (2 ** (depth - 1 - i)) for i in range(depth)]
        self.to_emb = conv3x3(in_channels, planes[0], dtype=dtype)
        skips = [planes[0]]
        self.conv_layers = nn.ModuleList()
        for i in range(depth):
            self.conv_layers.append(ConvBlock(skips[-1], planes[i] * 2, "conv", norm_layer, dtype))
            skips.append(planes[i] * 2)
        ch = skips.pop()
        self.deconv_layers = nn.ModuleList()
        for i in range(depth):
            if i > 0:
                ch += skips.pop()
            self.deconv_layers.append(ConvBlock(ch, planes[-1 - i], "deconv", norm_layer, dtype))
            ch = planes[-1 - i]
        ch += skips.pop()
        self.from_emb = conv3x3(ch, num_channels_out, dtype=dtype, zero_init=zero_init)

    def forward(self, x):
        ys = [self.to_emb(x.permute(0, 3, 1, 2))]
        for layer in self.conv_layers:
            ys.append(layer(ys[-1]))
        y = ys.pop()
        for i, layer in enumerate(self.deconv_layers):
            if i > 0:
                y = torch.cat([y, ys.pop()], dim=1)
            y = layer(y)
        y = torch.cat([y, ys.pop()], dim=1)
        return self.from_emb(y).permute(0, 2, 3, 1)


class ConvPatchProj(nn.Module):
    """Patchify (image (B,H,W,C) -> tokens (B,L,E), ``from_patch=True``) or
    unpatchify (tokens (B,L,E) -> image (B,H,W,C)) through stride-2 conv
    stacks, log2(patch_size) of them."""

    def __init__(self, patch_size, embed_dim, norm_layer, num_channels, from_patch=True,
                 zero_init_proj=False, dtype=torch.float32):
        super().__init__()
        num_dims = int(math.log2(patch_size))
        dims = [embed_dim // (2 ** k) for k in range(num_dims)] + [num_channels]
        self.from_patch = from_patch
        self.num_channels = num_channels
        if from_patch:
            dims = dims[::-1]
            inner = dims[1:]
            self.conv_in = conv_down(num_channels, dims[1], dtype=dtype)
            self.blocks = nn.ModuleList(
                ConvBlock(inner[i], inner[i + 1], "conv", norm_layer, dtype)
                for i in range(len(inner) - 2))
            self.conv_out = conv_down(inner[-2], inner[-1], dtype=dtype)
        else:
            layer_dims = dims[:-1]
            self.blocks = nn.ModuleList(
                ConvBlock(layer_dims[i], layer_dims[i + 1], "deconv", norm_layer, dtype)
                for i in range(len(layer_dims) - 1))
            self.proj = deconv_up(dims[-2], dims[-1], dtype=dtype, zero_init=zero_init_proj)

    def forward(self, x, latent_shape=None):
        if self.from_patch:
            c = x.shape[-1]
            if c == self.num_channels - 1:
                x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
            if c == self.num_channels + 1:
                x = x[..., : self.num_channels]
            x = self.conv_in(x.permute(0, 3, 1, 2))
            for blk in self.blocks:
                x = blk(x)
            x = self.conv_out(x)
            return x.flatten(2).transpose(1, 2)  # (B, h*w, E)
        if latent_shape is None:
            raise ValueError("unpatchify needs latent_shape")
        b, l, c = x.shape
        h, w = latent_shape
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        for blk in self.blocks:
            x = blk(x)
        return self.proj(x).permute(0, 2, 3, 1)
