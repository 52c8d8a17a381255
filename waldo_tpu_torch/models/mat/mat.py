"""MAT generator (Mask-Aware Transformer inpainting), channel-last
(counterpart of waldo_tpu/models/mat/mat.py).

Partial convs, window attention with mask-aware key masking (additive -100,
not -inf), Swin stages with patch merge and upsample, the style-modulated
two-stage synthesis and the z -> w mapping. Module names are the flax
names, so parameter paths match the JAX tree one for one. ``noise_mode``:
``"const"`` blends the style tokens with a deterministic 0.5 map (the
inpainter's setting), ``"random"`` with a Bernoulli(0.5) map drawn from the
caller's ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .basic import Conv2dLayer, FullyConnectedLayer, MappingNet, StyleConv, ToRGB


def nf(stage: int) -> int:
    return {9: 64, 8: 128, 7: 256, 6: 512, 5: 512, 4: 512, 3: 512, 2: 512}[stage]


# ---------------------------------------------------------------------------
# tokens <-> features, windows
# ---------------------------------------------------------------------------

def token2feature(x, size):
    b, n, c = x.shape
    h, w = size
    return x.reshape(b, h, w, c)


def feature2token(x):
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c)


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows, ws, h, w):
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def shift_attn_mask(h, w, window_size, shift) -> np.ndarray:
    """SW-MSA region mask (nW, ws*ws, ws*ws): 0 within a region, -100
    across regions; float32 numpy."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -window_size), slice(-window_size, -shift), slice(-shift, None)):
        for wsl in (slice(0, -window_size), slice(-window_size, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    ws = window_size
    mw = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    attn = mw[:, None, :] - mw[:, :, None]
    return np.where(attn != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# partial conv + window attention
# ---------------------------------------------------------------------------

class Conv2dLayerPartial(nn.Module):
    """Partial convolution: the output is renormalized by the share of valid
    (mask 1) inputs under the kernel; returns the updated mask too."""

    def __init__(self, in_channels, features, kernel_size, activation="linear", up=1, down=1):
        super().__init__()
        self.conv = Conv2dLayer(in_channels, features, kernel_size, activation=activation,
                                up=up, down=down)
        self.k, self.up, self.down = kernel_size, up, down

    def forward(self, x, mask=None):
        if mask is None:
            return self.conv(x), None
        k = self.k
        pad = k // 2 if k % 2 == 1 else 0
        ones = torch.ones((1, 1, k, k), dtype=mask.dtype, device=mask.device)
        update = F.conv2d(mask.permute(0, 3, 1, 2), ones, stride=self.down, padding=pad)
        update = update.permute(0, 2, 3, 1)
        if self.up > 1:  # nearest, integer factor
            update = update.repeat_interleave(self.up, 1).repeat_interleave(self.up, 2)
        ratio = (k * k) / (update + 1e-8)
        update = update.clamp(0.0, 1.0)
        ratio = ratio * update
        return self.conv(x) * ratio, update


class WindowAttention(nn.Module):
    """W-MSA with l2-normalized queries and keys and mask-aware keys: a key
    whose mask is 0 gets -100 added, and the window's mask becomes 1 where
    any key was valid."""

    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        for name in ("q", "k", "v", "proj"):
            self.add_module(name, FullyConnectedLayer(dim, dim))

    def forward(self, x, mask_windows=None, mask=None):
        b_, n, c = x.shape
        hn = self.num_heads
        d = c // hn
        norm_x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        q = self.q(norm_x).reshape(b_, n, hn, d).permute(0, 2, 1, 3)
        k = self.k(norm_x).reshape(b_, n, hn, d).permute(0, 2, 3, 1)
        v = self.v(x).reshape(b_, n, hn, d).permute(0, 2, 1, 3)
        attn = (q @ k) * (d ** -0.5)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, hn, n, n) + mask[None, :, None]
            attn = attn.reshape(-1, hn, n, n)
        if mask_windows is not None:
            m = mask_windows[..., 0][:, None, None, :]  # (B_, 1, 1, N)
            attn = attn + torch.where(m == 0, -100.0, 0.0)
            mask_windows = mask_windows.sum(dim=1, keepdim=True).clamp(0.0, 1.0)
            mask_windows = mask_windows.expand(-1, n, -1)
        attn = attn.softmax(dim=-1)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(b_, n, c)
        return self.proj(out), mask_windows


class SwinBlock(nn.Module):
    """Swin block with the fuse shortcut: (shifted) window attention, then
    fuse(cat(shortcut, x)) and a two-layer lrelu MLP."""

    def __init__(self, dim, num_heads, window_size=7, shift_size=0, mlp_ratio=2.0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.attn = WindowAttention(dim, num_heads)
        hidden = int(dim * mlp_ratio)
        self.fuse = FullyConnectedLayer(2 * dim, dim, activation="lrelu")
        self.mlp_fc1 = FullyConnectedLayer(dim, hidden, activation="lrelu")
        self.mlp_fc2 = FullyConnectedLayer(hidden, dim)
        self._attn_masks: Dict[tuple, torch.Tensor] = {}

    def _attn_mask(self, h, w, ws, ss, device):
        key = (h, w, ws, ss, str(device))
        if key not in self._attn_masks:
            self._attn_masks[key] = torch.from_numpy(shift_attn_mask(h, w, ws, ss)).to(device)
        return self._attn_masks[key]

    def forward(self, x, x_size, mask=None):
        h, w = x_size
        b, _, c = x.shape
        ws, ss = self.window_size, self.shift_size
        if min(x_size) <= ws:
            ss = 0
            ws = min(x_size)

        shortcut = x
        x = x.reshape(b, h, w, c)
        if mask is not None:
            mask = mask.reshape(b, h, w, 1)
        if ss > 0:
            x = torch.roll(x, (-ss, -ss), dims=(1, 2))
            if mask is not None:
                mask = torch.roll(mask, (-ss, -ss), dims=(1, 2))
        xw = window_partition(x, ws)
        mw = window_partition(mask, ws) if mask is not None else None
        attn_mask = self._attn_mask(h, w, ws, ss, x.device) if ss > 0 else None
        xw, mw = self.attn(xw, mw, attn_mask)
        x = window_reverse(xw, ws, h, w)
        if mw is not None:
            mask = window_reverse(mw.reshape(-1, ws, ws, 1), ws, h, w)
        if ss > 0:
            x = torch.roll(x, (ss, ss), dims=(1, 2))
            if mask is not None:
                mask = torch.roll(mask, (ss, ss), dims=(1, 2))
        x = x.reshape(b, h * w, c)
        if mask is not None:
            mask = mask.reshape(b, h * w, 1)
        x = self.fuse(torch.cat([shortcut, x], dim=-1))
        x = self.mlp_fc2(self.mlp_fc1(x))
        return x, mask


class PatchMerging(nn.Module):
    def __init__(self, dim, features, down=2):
        super().__init__()
        self.down = down
        self.conv = Conv2dLayerPartial(dim, features, 3, activation="lrelu", down=down)

    def forward(self, x, x_size, mask=None):
        x = token2feature(x, x_size)
        if mask is not None:
            mask = token2feature(mask, x_size)
        x, mask = self.conv(x, mask)
        x_size = (x_size[0] // self.down, x_size[1] // self.down)
        return feature2token(x), x_size, (feature2token(mask) if mask is not None else None)


class PatchUpsampling(nn.Module):
    def __init__(self, dim, features, up=2):
        super().__init__()
        self.up = up
        self.conv = Conv2dLayerPartial(dim, features, 3, activation="lrelu", up=up)

    def forward(self, x, x_size, mask=None):
        x = token2feature(x, x_size)
        if mask is not None:
            mask = token2feature(mask, x_size)
        x, mask = self.conv(x, mask)
        x_size = (x_size[0] * self.up, x_size[1] * self.up)
        return feature2token(x), x_size, (feature2token(mask) if mask is not None else None)


class BasicLayer(nn.Module):
    """Swin stage: optional resample, ``depth`` blocks (odd ones shifted by
    half a window), then a partial-conv residual."""

    def __init__(self, dim, depth, num_heads, window_size, resample: Optional[str] = None,
                 resample_factor=2):
        super().__init__()
        self.depth = depth
        if resample == "down":
            self.downsample = PatchMerging(dim, dim, resample_factor)
        elif resample == "up":
            self.upsample = PatchUpsampling(dim, dim, resample_factor)
        self.resample = resample
        for i in range(depth):
            self.add_module(f"block{i}", SwinBlock(
                dim, num_heads, window_size, shift_size=0 if i % 2 == 0 else window_size // 2))
        self.conv = Conv2dLayerPartial(dim, dim, 3, activation="lrelu")

    def forward(self, x, x_size, mask=None):
        if self.resample == "down":
            x, x_size, mask = self.downsample(x, x_size, mask)
        elif self.resample == "up":
            x, x_size, mask = self.upsample(x, x_size, mask)
        identity = x
        for i in range(self.depth):
            x, mask = getattr(self, f"block{i}")(x, x_size, mask)
        m = token2feature(mask, x_size) if mask is not None else None
        xf, m = self.conv(token2feature(x, x_size), m)
        x = feature2token(xf) + identity
        return x, x_size, (feature2token(m) if m is not None else None)


# ---------------------------------------------------------------------------
# encoder / style / decoder (second stage)
# ---------------------------------------------------------------------------

class EncFromRGB(nn.Module):
    def __init__(self, in_channels, features):
        super().__init__()
        self.conv0 = Conv2dLayer(in_channels, features, 1, activation="lrelu")
        self.conv1 = Conv2dLayer(features, features, 3, activation="lrelu")

    def forward(self, x):
        return self.conv1(self.conv0(x))


class ConvBlockDown(nn.Module):
    def __init__(self, in_channels, features):
        super().__init__()
        self.conv0 = Conv2dLayer(in_channels, features, 3, activation="lrelu", down=2)
        self.conv1 = Conv2dLayer(features, features, 3, activation="lrelu")

    def forward(self, x):
        return self.conv1(self.conv0(x))


class Encoder(nn.Module):
    """Features at every resolution from 2**res_log2 down to 16, keyed by
    log2 resolution."""

    def __init__(self, res_log2, img_channels=3):
        super().__init__()
        self.res_log2 = res_log2
        for i in range(res_log2, 3, -1):
            if i == res_log2:
                blk = EncFromRGB(img_channels * 2 + 1, nf(i))
            else:
                blk = ConvBlockDown(nf(i + 1), nf(i))
            self.add_module(f"b{i}", blk)

    def forward(self, x):
        out = {}
        for i in range(self.res_log2, 3, -1):
            x = getattr(self, f"b{i}")(x)
            out[i] = x
        return out


class ToStyle(nn.Module):
    def __init__(self, in_channels, features):
        super().__init__()
        for i in range(3):
            self.add_module(f"conv{i}", Conv2dLayer(in_channels, in_channels, 3,
                                                    activation="lrelu", down=2))
        self.fc = FullyConnectedLayer(in_channels, features, activation="lrelu")

    def forward(self, x):
        for i in range(3):
            x = getattr(self, f"conv{i}")(x)
        return self.fc(x.mean(dim=(1, 2)))


class DecBlockFirstV2(nn.Module):
    """16x16 decoder head."""

    def __init__(self, in_features, out_features, style_dim, use_noise, demodulate,
                 img_channels):
        super().__init__()
        self.conv0 = Conv2dLayer(in_features, in_features, 3, activation="lrelu")
        self.conv1 = StyleConv(in_features, out_features, style_dim, 16, 3,
                               use_noise=use_noise, demodulate=demodulate)
        self.toRGB = ToRGB(out_features, img_channels, style_dim)

    def forward(self, x, ws, gs, e_features, noise_mode="random", generator=None):
        x = self.conv0(x) + e_features[4]
        style = torch.cat([ws[:, 0], gs], dim=1)
        x = self.conv1(x, style, noise_mode, generator=generator)
        style = torch.cat([ws[:, 1], gs], dim=1)
        return x, self.toRGB(x, style)


class DecBlock(nn.Module):
    """Upsampling decoder block at resolution 2**res."""

    def __init__(self, res, in_features, out_features, style_dim, use_noise, demodulate,
                 img_channels):
        super().__init__()
        self.res = res
        self.conv0 = StyleConv(in_features, out_features, style_dim, 2 ** res, 3, up=2,
                               use_noise=use_noise, demodulate=demodulate)
        self.conv1 = StyleConv(out_features, out_features, style_dim, 2 ** res, 3,
                               use_noise=use_noise, demodulate=demodulate)
        self.toRGB = ToRGB(out_features, img_channels, style_dim)

    def forward(self, x, img, ws, gs, e_features, noise_mode="random", generator=None):
        r = self.res
        style = torch.cat([ws[:, r * 2 - 9], gs], dim=1)
        x = self.conv0(x, style, noise_mode, generator=generator)
        x = x + e_features[r]
        style = torch.cat([ws[:, r * 2 - 8], gs], dim=1)
        x = self.conv1(x, style, noise_mode, generator=generator)
        style = torch.cat([ws[:, r * 2 - 7], gs], dim=1)
        return x, self.toRGB(x, style, skip=img)


class Decoder(nn.Module):
    def __init__(self, res_log2, style_dim, use_noise, demodulate, img_channels):
        super().__init__()
        self.res_log2 = res_log2
        self.add_module("Dec_16x16", DecBlockFirstV2(nf(4), nf(4), style_dim, use_noise,
                                                     demodulate, img_channels))
        for res in range(5, res_log2 + 1):
            self.add_module(f"Dec_{2 ** res}x{2 ** res}", DecBlock(
                res, nf(res - 1), nf(res), style_dim, use_noise, demodulate, img_channels))

    def forward(self, x, ws, gs, e_features, noise_mode="random", generator=None):
        x, img = getattr(self, "Dec_16x16")(x, ws, gs, e_features, noise_mode, generator)
        for res in range(5, self.res_log2 + 1):
            x, img = getattr(self, f"Dec_{2 ** res}x{2 ** res}")(
                x, img, ws, gs, e_features, noise_mode, generator)
        return img


class DecStyleBlock(nn.Module):
    """First-stage decoder block (upsampling, skip-added)."""

    def __init__(self, features, style_dim, resolution, use_noise, demodulate, img_channels):
        super().__init__()
        self.conv0 = StyleConv(features, features, style_dim, resolution, 3, up=2,
                               use_noise=use_noise, demodulate=demodulate)
        self.conv1 = StyleConv(features, features, style_dim, resolution, 3,
                               use_noise=use_noise, demodulate=demodulate)
        self.toRGB = ToRGB(features, img_channels, style_dim)

    def forward(self, x, img, style, skip, noise_mode="random", generator=None):
        x = self.conv0(x, style, noise_mode, generator=generator) + skip
        x = self.conv1(x, style, noise_mode, generator=generator)
        return x, self.toRGB(x, style, skip=img)


def _mul_map(x, noise_mode, generator):
    if noise_mode == "random":
        if generator is None:
            raise ValueError("noise_mode='random' needs a torch.Generator")
        return torch.bernoulli(torch.full_like(x, 0.5), generator=generator)
    return torch.full_like(x, 0.5)


class FirstStage(nn.Module):
    """Conv encoder -> Swin stages 64 -> 16 -> 64 -> style decoder."""

    def __init__(self, img_channels=3, img_resolution=512, dim=180, w_dim=512,
                 use_noise=False, demodulate=True):
        super().__init__()
        self.down_time = int(math.log2(img_resolution // 64))
        self.conv_first = Conv2dLayerPartial(img_channels + 1, dim, 3, activation="lrelu")
        for i in range(self.down_time):
            self.add_module(f"enc_conv{i}", Conv2dLayerPartial(dim, dim, 3, down=2,
                                                               activation="lrelu"))
        self.depths = [2, 3, 4, 3, 2]
        ratios = [1, 0.5, 0.5, 2, 2]
        window_sizes = [8, 16, 16, 16, 8]
        for i, depth in enumerate(self.depths):
            resample = "down" if ratios[i] < 1 else ("up" if ratios[i] > 1 else None)
            factor = int(1 / ratios[i]) if ratios[i] < 1 else int(ratios[i])
            self.add_module(f"tran{i}", BasicLayer(dim, depth, 6, window_sizes[i],
                                                   resample=resample, resample_factor=factor))
        self.ws_style = FullyConnectedLayer(w_dim, dim, activation="lrelu")
        self.to_square = FullyConnectedLayer(dim, 16 * 16, activation="lrelu")
        for j in range(4):
            self.add_module(f"down_conv{j}", Conv2dLayer(dim, dim, 3, down=2,
                                                         activation="lrelu"))
        self.to_style = FullyConnectedLayer(dim, dim * 2, activation="lrelu")
        for i in range(self.down_time):
            self.add_module(f"dec_conv{i}", DecStyleBlock(
                dim, dim * 3, img_resolution // 2 ** (self.down_time - 1 - i),
                use_noise, demodulate, img_channels))

    def forward(self, images_in, masks_in, ws, noise_mode="random", generator=None):
        x = torch.cat([masks_in - 0.5, images_in * masks_in], dim=-1)
        skips = []
        x, mask = self.conv_first(x, masks_in)
        skips.append(x)
        for i in range(self.down_time):
            x, mask = getattr(self, f"enc_conv{i}")(x, mask)
            if i != self.down_time - 1:
                skips.append(x)

        x_size = (x.shape[1], x.shape[2])
        x = feature2token(x)
        mask = feature2token(mask)
        mid = len(self.depths) // 2
        style = None
        for i in range(len(self.depths)):
            layer = getattr(self, f"tran{i}")
            if i < mid:
                x, x_size, mask = layer(x, x_size, mask)
                skips.append(x)
            elif i > mid:
                x, x_size, mask = layer(x, x_size, None)
                x = x + skips[mid - i]
            else:
                x, x_size, mask = layer(x, x_size, None)
                mul_map = _mul_map(x, noise_mode, generator)
                ws_s = self.ws_style(ws[:, -1])
                # (B, 256, 1): the middle stage always holds 16x16 tokens, so
                # the JAX package's linear resize to the token count is the
                # identity
                add_n = self.to_square(ws_s)[:, :, None]
                x = x * mul_map + add_n * (1 - mul_map)
                xf = token2feature(x, x_size)
                for j in range(4):
                    xf = getattr(self, f"down_conv{j}")(xf)
                gs = self.to_style(xf.mean(dim=(1, 2)))
                style = torch.cat([gs, ws_s], dim=1)

        x = token2feature(x, x_size)
        img = None
        for i in range(self.down_time):
            x, img = getattr(self, f"dec_conv{i}")(
                x, img, style, skips[self.down_time - i - 1], noise_mode, generator)
        return img * (1 - masks_in) + images_in * masks_in


class SynthesisNet(nn.Module):
    """Two-stage synthesis: the first stage's fill, then the conv encoder,
    the 16x16 style blend and the style decoder."""

    def __init__(self, w_dim=512, img_resolution=512, img_channels=3, use_noise=True,
                 demodulate=True):
        super().__init__()
        self.res_log2 = int(math.log2(img_resolution))
        self.first_stage = FirstStage(img_channels, img_resolution, 180, w_dim,
                                      use_noise=False, demodulate=demodulate)
        self.enc = Encoder(self.res_log2, img_channels)
        self.to_square = FullyConnectedLayer(w_dim, 16 * 16, activation="lrelu")
        self.to_style = ToStyle(nf(4), nf(2) * 2)
        self.dec = Decoder(self.res_log2, w_dim + nf(2) * 2, use_noise, demodulate,
                           img_channels)

    def forward(self, images_in, masks_in, ws, noise_mode="random", generator=None):
        out_stg1 = self.first_stage(images_in, masks_in, ws, noise_mode, generator)
        x = images_in * masks_in + out_stg1 * (1 - masks_in)
        x = torch.cat([masks_in - 0.5, x, images_in * masks_in], dim=-1)
        e_features = self.enc(x)

        fea_16 = e_features[4]
        mul_map = _mul_map(fea_16, noise_mode, generator)
        # fea_16 is 16x16, so the JAX package's bilinear resize is the identity
        add_n = self.to_square(ws[:, 0]).reshape(-1, 16, 16, 1)
        fea_16 = fea_16 * mul_map + add_n * (1 - mul_map)
        e_features[4] = fea_16

        gs = self.to_style(fea_16)
        img = self.dec(fea_16, ws, gs, e_features, noise_mode, generator)
        return img * (1 - masks_in) + images_in * masks_in


class Generator(nn.Module):
    """Mapping + synthesis. images_in (B, R, R, 3) in [-1, 1], masks_in
    (B, R, R, 1) with 1 = keep, z (B, z_dim) -> (B, R, R, 3)."""

    def __init__(self, z_dim=512, w_dim=512, img_resolution=512, img_channels=3):
        super().__init__()
        res_log2 = int(math.log2(img_resolution))
        self.img_resolution = img_resolution
        self.mapping = MappingNet(z_dim, w_dim, res_log2 * 2 - 3 * 2)
        self.synthesis = SynthesisNet(w_dim, img_resolution, img_channels)

    def forward(self, images_in, masks_in, z, truncation_psi=1.0, noise_mode="random",
                generator=None):
        ws = self.mapping(z, truncation_psi=truncation_psi)
        return self.synthesis(images_in, masks_in, ws, noise_mode, generator=generator)
