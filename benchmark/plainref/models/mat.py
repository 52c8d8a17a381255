"""The plain MAT generator (Mask-Aware Transformer inpainting, Li et al.,
CVPR 2022; github.com/fenglinglwb/MAT ``networks/mat.py`` and
``networks/basic_module.py``, the Places512 generator), channel-last, in
plain PyTorch float32: the port's ``models/mat/{basic,mat}.py`` copied, with
the plain ``bias_act`` and ``upfirdn2d`` of ``ops/``. Parameter and buffer
names are the port's, so one state dict loads into both.

Departures from the published MAT, as the port's ``MatInpainter`` runs it:
noise ``"const"`` only (the stored ``noise_const`` plane, and a constant 0.5
map where the published code blends the style tokens with a random one);
the mask-aware attention adds -100 to a key whose mask is 0 (the published
``masked_fill(..., -100)`` as an addition); weight gains applied at run time
(equalized learning rate); no ``conv_clamp`` (the published generator sets
none at inference).

``WindowAttention.mask_keys`` False leaves the key mask out, so every key is
attended: a fault the benchmark reads the limits against, never set in a
check.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.bias_act import ACTS, bias_act
from ..ops.upfirdn2d import setup_filter, upfirdn2d, upsample2d


def nf(stage: int) -> int:
    return {9: 64, 8: 128, 7: 256, 6: 512, 5: 512, 4: 512, 3: 512, 2: 512}[stage]


def _filter(module: nn.Module, taps=(1, 3, 3, 1)) -> None:
    module.register_buffer("resample_filter", setup_filter(taps), persistent=False)


# -- StyleGAN2 basic modules --


class FullyConnectedLayer(nn.Module):
    """Equalized-lr dense: gain lr_multiplier / sqrt(in) at run time, bias
    scaled by lr_multiplier, fused activation. ``weight`` (out, in)."""

    def __init__(self, in_features, features, activation="linear", lr_multiplier=1.0,
                 bias_init=0.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))
        self.activation, self.lr_multiplier, self.bias_init = activation, lr_multiplier, bias_init
        self.weight_gain = lr_multiplier / math.sqrt(in_features)

    def forward(self, x):
        y = x @ (self.weight * self.weight_gain).t()
        return bias_act(y, self.bias * self.lr_multiplier, act=self.activation)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1):
    """Conv with up/down resampling: upfirdn2d (zero insertion, padding, the
    filter), a VALID conv, then the filtered downsample."""
    px0 = px1 = py0 = py1 = padding
    fh, fw = tuple(f.shape) if f is not None else (1, 1)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2
    x = upfirdn2d(x, f if up > 1 else None, up=up, padding=(px0, px1, py0, py1), gain=up ** 2)
    x = F.conv2d(x.permute(0, 3, 1, 2), w, groups=groups).permute(0, 2, 3, 1)
    if down > 1:
        x = upfirdn2d(x, f, down=down)
    return x


class Conv2dLayer(nn.Module):
    """Equalized-lr conv with resampling and fused bias + activation.
    ``weight`` (out, in, k, k)."""

    def __init__(self, in_channels, features, kernel_size, activation="linear", up=1, down=1):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_channels, k, k))
        self.bias = nn.Parameter(torch.empty(features))
        self.activation, self.up, self.down, self.padding = activation, up, down, k // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * k * k)
        _filter(self)

    def forward(self, x):
        y = conv2d_resample(x, self.weight * self.weight_gain, f=self.resample_filter,
                            up=self.up, down=self.down, padding=self.padding)
        return bias_act(y, self.bias, act=self.activation, gain=ACTS[self.activation][1])


class ModulatedConv2d(nn.Module):
    """Style-modulated conv: the style's affine map scales the weight's input
    channels, demodulation rescales each output channel by rsqrt(sum w^2 +
    1e-8); the samples run as one grouped conv."""

    def __init__(self, in_channels, features, kernel_size, style_dim, demodulate=True, up=1):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_channels, k, k))
        self.affine = FullyConnectedLayer(style_dim, in_channels, bias_init=1.0)
        self.demodulate, self.up, self.padding = demodulate, up, k // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * k * k)
        _filter(self)

    def forward(self, x, style):
        b, h, w, cin = x.shape
        s = self.affine(style)
        wt = self.weight[None] * self.weight_gain * s[:, None, :, None, None]
        if self.demodulate:
            wt = wt * torch.rsqrt(wt.square().sum(dim=(2, 3, 4)) + 1e-8)[:, :, None, None, None]
        xg = x.permute(1, 2, 0, 3).reshape(1, h, w, b * cin)
        y = conv2d_resample(xg, wt.reshape((-1,) + tuple(wt.shape[2:])), f=self.resample_filter,
                            up=self.up, padding=self.padding, groups=b)
        ho, wo = y.shape[1:3]
        return y.reshape(ho, wo, b, -1).permute(2, 0, 1, 3)


class StyleConv(nn.Module):
    """ModulatedConv2d, the const noise plane times ``noise_strength``, fused
    bias + lrelu."""

    def __init__(self, in_channels, features, style_dim, resolution, kernel_size=3, up=1,
                 use_noise=True, demodulate=True):
        super().__init__()
        self.conv = ModulatedConv2d(in_channels, features, kernel_size, style_dim,
                                    demodulate=demodulate, up=up)
        self.use_noise = use_noise
        if use_noise:
            self.noise_strength = nn.Parameter(torch.empty(()))
            self.register_buffer("noise_const", torch.empty(resolution, resolution))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x, style):
        x = self.conv(x, style)
        if self.use_noise:
            x = x + self.noise_const[None, :, :, None] * self.noise_strength
        return bias_act(x, self.bias, act="lrelu", gain=ACTS["lrelu"][1])


class ToRGB(nn.Module):
    """Modulated 1x1 conv to RGB, plus the upsampled skip image."""

    def __init__(self, in_channels, features, style_dim):
        super().__init__()
        self.conv = ModulatedConv2d(in_channels, features, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.empty(features))
        _filter(self)

    def forward(self, x, style, skip=None):
        out = bias_act(self.conv(x, style), self.bias)
        if skip is not None:
            if skip.shape != out.shape:
                skip = upsample2d(skip, self.resample_filter)
            out = out + skip
        return out


class MappingNet(nn.Module):
    """z -> w: 2nd-moment normalization, 8 lrelu FCs at lr 0.01, broadcast to
    ``num_ws``, truncation toward the ``w_avg`` buffer."""

    def __init__(self, z_dim, w_dim, num_ws, num_layers=8, lr_multiplier=0.01):
        super().__init__()
        self.num_ws, self.num_layers = num_ws, num_layers
        for i in range(num_layers):
            self.add_module(f"fc{i}", FullyConnectedLayer(
                z_dim if i == 0 else w_dim, w_dim, activation="lrelu",
                lr_multiplier=lr_multiplier))
        self.register_buffer("w_avg", torch.empty(w_dim))

    def forward(self, z, truncation_psi=1.0):
        x = z.float() * torch.rsqrt(z.float().square().mean(dim=-1, keepdim=True) + 1e-8)
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        ws = x[:, None].expand(-1, self.num_ws, -1)
        if truncation_psi == 1.0:
            return ws
        return self.w_avg + truncation_psi * (ws - self.w_avg)


# -- the first stage: partial convs and mask-aware Swin stages --


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows, ws, h, w):
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def shift_attn_mask(h, w, ws, shift) -> torch.Tensor:
    """SW-MSA's region mask (nW, ws*ws, ws*ws): 0 within a region, -100
    across."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return torch.from_numpy(np.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0)
                            .astype(np.float32))


class Conv2dLayerPartial(nn.Module):
    """Partial conv: the output scaled by k*k over the valid inputs under the
    kernel; the mask becomes 1 where any input was valid."""

    def __init__(self, in_channels, features, kernel_size, activation="linear", up=1, down=1):
        super().__init__()
        self.conv = Conv2dLayer(in_channels, features, kernel_size, activation=activation,
                                up=up, down=down)
        self.k, self.up, self.down = kernel_size, up, down

    def forward(self, x, mask=None):
        if mask is None:
            return self.conv(x), None
        k = self.k
        ones = torch.ones((1, 1, k, k), dtype=mask.dtype, device=mask.device)
        update = F.conv2d(mask.permute(0, 3, 1, 2), ones, stride=self.down,
                          padding=k // 2).permute(0, 2, 3, 1)
        if self.up > 1:
            update = update.repeat_interleave(self.up, 1).repeat_interleave(self.up, 2)
        ratio = (k * k) / (update + 1e-8)
        update = update.clamp(0.0, 1.0)
        return self.conv(x) * (ratio * update), update


class WindowAttention(nn.Module):
    """W-MSA on l2-normalized queries and keys; a key whose mask is 0 gets
    -100 added, and each window's mask becomes 1 where any key was valid."""

    mask_keys = True

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
            attn = (attn.reshape(b_ // nw, nw, hn, n, n) + mask[None, :, None]).reshape(-1, hn, n, n)
        if mask_windows is not None:
            if self.mask_keys:
                attn = attn + torch.where(mask_windows[..., 0][:, None, None, :] == 0, -100.0, 0.0)
            mask_windows = mask_windows.sum(dim=1, keepdim=True).clamp(0.0, 1.0).expand(-1, n, -1)
        out = (attn.softmax(dim=-1) @ v).permute(0, 2, 1, 3).reshape(b_, n, c)
        return self.proj(out), mask_windows


class SwinBlock(nn.Module):
    """(Shifted) window attention, fuse(cat(shortcut, x)), a two-layer lrelu
    MLP."""

    def __init__(self, dim, num_heads, window_size, shift_size=0, mlp_ratio=2.0):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.attn = WindowAttention(dim, num_heads)
        self.fuse = FullyConnectedLayer(2 * dim, dim, activation="lrelu")
        self.mlp_fc1 = FullyConnectedLayer(dim, int(dim * mlp_ratio), activation="lrelu")
        self.mlp_fc2 = FullyConnectedLayer(int(dim * mlp_ratio), dim)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def forward(self, x, x_size, mask=None):
        h, w = x_size
        b, _, c = x.shape
        ws, ss = self.window_size, self.shift_size
        if min(x_size) <= ws:
            ss, ws = 0, min(x_size)
        shortcut = x
        x = x.reshape(b, h, w, c)
        if mask is not None:
            mask = mask.reshape(b, h, w, 1)
        if ss > 0:
            x = torch.roll(x, (-ss, -ss), dims=(1, 2))
            if mask is not None:
                mask = torch.roll(mask, (-ss, -ss), dims=(1, 2))
        attn_mask = None
        if ss > 0:
            key = (h, w, ws, ss, str(x.device))
            if key not in self._masks:
                self._masks[key] = shift_attn_mask(h, w, ws, ss).to(x.device)
            attn_mask = self._masks[key]
        xw, mw = self.attn(window_partition(x, ws),
                           window_partition(mask, ws) if mask is not None else None, attn_mask)
        x = window_reverse(xw, ws, h, w)
        if mw is not None:
            mask = window_reverse(mw.reshape(-1, ws, ws, 1), ws, h, w)
        if ss > 0:
            x = torch.roll(x, (ss, ss), dims=(1, 2))
            if mask is not None:
                mask = torch.roll(mask, (ss, ss), dims=(1, 2))
        x = self.fuse(torch.cat([shortcut, x.reshape(b, h * w, c)], dim=-1))
        x = self.mlp_fc2(self.mlp_fc1(x))
        return x, (mask.reshape(b, h * w, 1) if mask is not None else None)


class _Resample(nn.Module):
    """PatchMerging (``down``) or PatchUpsampling (``up``): a partial 3x3
    lrelu conv that resamples the tokens by ``factor``."""

    def __init__(self, dim, factor, up):
        super().__init__()
        self.up, self.factor = up, factor
        self.conv = Conv2dLayerPartial(dim, dim, 3, activation="lrelu",
                                       up=factor if up else 1, down=1 if up else factor)

    def forward(self, x, x_size, mask=None):
        b, _, c = x.shape
        x, mask = self.conv(x.reshape(b, *x_size, c),
                            mask.reshape(b, *x_size, 1) if mask is not None else None)
        f = self.factor
        x_size = (x_size[0] * f, x_size[1] * f) if self.up else (x_size[0] // f, x_size[1] // f)
        tok = lambda t: t.reshape(b, -1, t.shape[-1])
        return tok(x), x_size, (tok(mask) if mask is not None else None)


class BasicLayer(nn.Module):
    """A Swin stage: optional resample, ``depth`` blocks (odd ones shifted by
    half a window), a partial-conv residual."""

    def __init__(self, dim, depth, num_heads, window_size, resample=None, factor=2):
        super().__init__()
        self.depth, self.resample = depth, resample
        if resample == "down":
            self.downsample = _Resample(dim, factor, up=False)
        elif resample == "up":
            self.upsample = _Resample(dim, factor, up=True)
        for i in range(depth):
            self.add_module(f"block{i}", SwinBlock(dim, num_heads, window_size,
                                                   0 if i % 2 == 0 else window_size // 2))
        self.conv = Conv2dLayerPartial(dim, dim, 3, activation="lrelu")

    def forward(self, x, x_size, mask=None):
        if self.resample is not None:
            x, x_size, mask = getattr(self, self.resample + "sample")(x, x_size, mask)
        identity = x
        for i in range(self.depth):
            x, mask = getattr(self, f"block{i}")(x, x_size, mask)
        b, _, c = x.shape
        m = mask.reshape(b, *x_size, 1) if mask is not None else None
        xf, m = self.conv(x.reshape(b, *x_size, c), m)
        x = xf.reshape(b, -1, c) + identity
        return x, x_size, (m.reshape(b, -1, 1) if m is not None else None)


class DecStyleBlock(nn.Module):
    def __init__(self, features, style_dim, resolution, demodulate):
        super().__init__()
        self.conv0 = StyleConv(features, features, style_dim, resolution, 3, up=2,
                               use_noise=False, demodulate=demodulate)
        self.conv1 = StyleConv(features, features, style_dim, resolution, 3,
                               use_noise=False, demodulate=demodulate)
        self.toRGB = ToRGB(features, 3, style_dim)

    def forward(self, x, img, style, skip):
        x = self.conv0(x, style) + skip
        x = self.conv1(x, style)
        return x, self.toRGB(x, style, skip=img)


class FirstStage(nn.Module):
    """Partial convs 512 -> 64, Swin stages 64 -> 16 -> 64 (depths
    [2,3,4,3,2], 6 heads, windows [8,16,16,16,8]) at dim 180, the style
    tokens, the style decoder back to 512."""

    def __init__(self, img_resolution=512, dim=180, w_dim=512, demodulate=True):
        super().__init__()
        self.down_time = int(math.log2(img_resolution // 64))
        self.conv_first = Conv2dLayerPartial(4, dim, 3, activation="lrelu")
        for i in range(self.down_time):
            self.add_module(f"enc_conv{i}", Conv2dLayerPartial(dim, dim, 3, down=2,
                                                               activation="lrelu"))
        self.depths = [2, 3, 4, 3, 2]
        for i, (depth, ratio, ws) in enumerate(zip(self.depths, [1, 0.5, 0.5, 2, 2],
                                                   [8, 16, 16, 16, 8])):
            resample = "down" if ratio < 1 else ("up" if ratio > 1 else None)
            self.add_module(f"tran{i}", BasicLayer(dim, depth, 6, ws, resample,
                                                   int(max(ratio, 1 / ratio))))
        self.ws_style = FullyConnectedLayer(w_dim, dim, activation="lrelu")
        self.to_square = FullyConnectedLayer(dim, 16 * 16, activation="lrelu")
        for j in range(4):
            self.add_module(f"down_conv{j}", Conv2dLayer(dim, dim, 3, down=2,
                                                         activation="lrelu"))
        self.to_style = FullyConnectedLayer(dim, dim * 2, activation="lrelu")
        for i in range(self.down_time):
            self.add_module(f"dec_conv{i}", DecStyleBlock(
                dim, dim * 3, img_resolution // 2 ** (self.down_time - 1 - i), demodulate))

    def forward(self, images_in, masks_in, ws):
        x = torch.cat([masks_in - 0.5, images_in * masks_in], dim=-1)
        x, mask = self.conv_first(x, masks_in)
        skips = [x]
        for i in range(self.down_time):
            x, mask = getattr(self, f"enc_conv{i}")(x, mask)
            if i != self.down_time - 1:
                skips.append(x)
        b, h, w, c = x.shape
        x_size, x, mask = (h, w), x.reshape(b, h * w, c), mask.reshape(b, h * w, 1)
        mid = len(self.depths) // 2
        for i in range(len(self.depths)):
            layer = getattr(self, f"tran{i}")
            if i < mid:
                x, x_size, mask = layer(x, x_size, mask)
                skips.append(x)
            elif i > mid:
                x, x_size, _ = layer(x, x_size, None)
                x = x + skips[mid - i]
            else:
                x, x_size, _ = layer(x, x_size, None)
                ws_s = self.ws_style(ws[:, -1])
                # the const noise: a 0.5 map blends the tokens with the style's square
                x = x * 0.5 + self.to_square(ws_s)[:, :, None] * 0.5
                xf = x.reshape(b, *x_size, c)
                for j in range(4):
                    xf = getattr(self, f"down_conv{j}")(xf)
                style = torch.cat([self.to_style(xf.mean(dim=(1, 2))), ws_s], dim=1)
        x = x.reshape(b, *x_size, c)
        img = None
        for i in range(self.down_time):
            x, img = getattr(self, f"dec_conv{i}")(x, img, style, skips[self.down_time - i - 1])
        return img * (1 - masks_in) + images_in * masks_in


# -- the second stage: conv encoder, style blend, modulated decoder --


class _ConvPair(nn.Module):
    """EncFromRGB (a 1x1 then a 3x3) or ConvBlockDown (a strided 3x3 then a
    3x3), lrelu."""

    def __init__(self, in_channels, features, first_k, down):
        super().__init__()
        self.conv0 = Conv2dLayer(in_channels, features, first_k, activation="lrelu", down=down)
        self.conv1 = Conv2dLayer(features, features, 3, activation="lrelu")

    def forward(self, x):
        return self.conv1(self.conv0(x))


class Encoder(nn.Module):
    def __init__(self, res_log2):
        super().__init__()
        self.res_log2 = res_log2
        for i in range(res_log2, 3, -1):
            self.add_module(f"b{i}", _ConvPair(7, nf(i), 1, 1) if i == res_log2
                            else _ConvPair(nf(i + 1), nf(i), 3, 2))

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
    def __init__(self, features, style_dim):
        super().__init__()
        self.conv0 = Conv2dLayer(features, features, 3, activation="lrelu")
        self.conv1 = StyleConv(features, features, style_dim, 16, 3)
        self.toRGB = ToRGB(features, 3, style_dim)

    def forward(self, x, ws, gs, e_features):
        x = self.conv0(x) + e_features[4]
        x = self.conv1(x, torch.cat([ws[:, 0], gs], dim=1))
        return x, self.toRGB(x, torch.cat([ws[:, 1], gs], dim=1))


class DecBlock(nn.Module):
    def __init__(self, res, in_features, features, style_dim):
        super().__init__()
        self.res = res
        self.conv0 = StyleConv(in_features, features, style_dim, 2 ** res, 3, up=2)
        self.conv1 = StyleConv(features, features, style_dim, 2 ** res, 3)
        self.toRGB = ToRGB(features, 3, style_dim)

    def forward(self, x, img, ws, gs, e_features):
        r = self.res
        x = self.conv0(x, torch.cat([ws[:, r * 2 - 9], gs], dim=1)) + e_features[r]
        x = self.conv1(x, torch.cat([ws[:, r * 2 - 8], gs], dim=1))
        return x, self.toRGB(x, torch.cat([ws[:, r * 2 - 7], gs], dim=1), skip=img)


class Decoder(nn.Module):
    def __init__(self, res_log2, style_dim):
        super().__init__()
        self.res_log2 = res_log2
        self.add_module("Dec_16x16", DecBlockFirstV2(nf(4), style_dim))
        for res in range(5, res_log2 + 1):
            self.add_module(f"Dec_{2 ** res}x{2 ** res}",
                            DecBlock(res, nf(res - 1), nf(res), style_dim))

    def forward(self, x, ws, gs, e_features):
        x, img = getattr(self, "Dec_16x16")(x, ws, gs, e_features)
        for res in range(5, self.res_log2 + 1):
            x, img = getattr(self, f"Dec_{2 ** res}x{2 ** res}")(x, img, ws, gs, e_features)
        return img


class SynthesisNet(nn.Module):
    def __init__(self, w_dim=512, img_resolution=512):
        super().__init__()
        self.res_log2 = int(math.log2(img_resolution))
        self.first_stage = FirstStage(img_resolution, 180, w_dim)
        self.enc = Encoder(self.res_log2)
        self.to_square = FullyConnectedLayer(w_dim, 16 * 16, activation="lrelu")
        self.to_style = ToStyle(nf(4), nf(2) * 2)
        self.dec = Decoder(self.res_log2, w_dim + nf(2) * 2)

    def forward(self, images_in, masks_in, ws):
        out_stg1 = self.first_stage(images_in, masks_in, ws)
        x = images_in * masks_in + out_stg1 * (1 - masks_in)
        e_features = self.enc(torch.cat([masks_in - 0.5, x, images_in * masks_in], dim=-1))
        # the const noise: a 0.5 map blends the 16x16 features with the style's square
        fea_16 = e_features[4] * 0.5 + self.to_square(ws[:, 0]).reshape(-1, 16, 16, 1) * 0.5
        e_features[4] = fea_16
        img = self.dec(fea_16, ws, self.to_style(fea_16), e_features)
        return img * (1 - masks_in) + images_in * masks_in


class Generator(nn.Module):
    """images_in (B, R, R, 3) in [-1, 1], masks_in (B, R, R, 1) with 1 =
    keep, z (B, 512) -> (B, R, R, 3)."""

    def __init__(self, z_dim=512, w_dim=512, img_resolution=512):
        super().__init__()
        res_log2 = int(math.log2(img_resolution))
        self.mapping = MappingNet(z_dim, w_dim, res_log2 * 2 - 6)
        self.synthesis = SynthesisNet(w_dim, img_resolution)

    def forward(self, images_in, masks_in, z, truncation_psi=1.0):
        return self.synthesis(images_in, masks_in, self.mapping(z, truncation_psi))
