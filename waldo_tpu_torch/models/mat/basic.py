"""StyleGAN2-style basic modules of MAT, channel-last (counterpart of
waldo_tpu/models/mat/basic.py).

Activations are (B, H, W, C) tensors. A convolution runs on the
channel-first view ``x.permute(0, 3, 1, 2)`` of a contiguous channel-last
tensor, which is channel-last memory for cuDNN, so its output permuted back
is again contiguous (..., C) data for the fused bias + activation (one
kernel launch on a CUDA device). Weight gains (equalized learning rate) are
applied at run time as in the JAX package. Parameters keep the JAX
package's names; ``waldo_tpu_torch.convert.mat_from_jax`` carries a flax
tree across.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.bias_act import _ACTS, bias_act
from ...ops.upfirdn2d import setup_filter, upfirdn2d, upsample2d


def normalize_2nd_moment(x, dim=-1, eps=1e-8):
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def _filter_buffer(module: nn.Module, taps) -> None:
    module.register_buffer("resample_filter", torch.from_numpy(setup_filter(list(taps))),
                           persistent=False)


class FullyConnectedLayer(nn.Module):
    """Equalized-lr dense: unit-normal init over ``lr_multiplier``, run-time
    gain lr_multiplier / sqrt(in), bias scaled by lr_multiplier, fused
    activation. ``weight`` is (out, in). With ``use_bias=False`` there is no
    ``bias`` and the fused activation runs without one."""

    def __init__(self, in_features, features, activation="linear", lr_multiplier=1.0,
                 bias_init=0.0, use_bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.bias_init = bias_init
        self.weight_gain = lr_multiplier / math.sqrt(in_features)

    @torch.no_grad()
    def init_parameters(self, generator):
        self.weight.normal_(generator=generator).div_(self.lr_multiplier)
        if self.bias is not None:
            self.bias.fill_(self.bias_init)

    def forward(self, x):
        y = x @ (self.weight * self.weight_gain).t()
        b = self.bias * self.lr_multiplier if self.bias is not None else None
        return bias_act(y, b, act=self.activation)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1):
    """2-D conv with up/down resampling, channel-last, on the JAX package's
    generic path: upfirdn2d (zero insertion, padding, FIR filter), a VALID
    conv, then the filtered downsample. x (B, H, W, Cin), w (Cout,
    Cin/groups, kh, kw)."""
    if isinstance(padding, int):
        px0 = px1 = py0 = py1 = padding
    else:
        px0, px1, py0, py1 = padding
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
    """Equalized-lr conv with resampling and fused bias/act. ``weight`` is
    (out, in, k, k). With ``use_bias=False`` there is no ``bias``."""

    def __init__(self, in_channels, features, kernel_size, activation="linear", up=1, down=1,
                 resample_filter=(1, 3, 3, 1), conv_clamp: Optional[float] = None,
                 use_bias=True):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_channels, k, k))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.activation, self.up, self.down, self.conv_clamp = activation, up, down, conv_clamp
        self.padding = k // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * k * k)
        _filter_buffer(self, resample_filter)

    @torch.no_grad()
    def init_parameters(self, generator):
        self.weight.normal_(generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x, gain=1.0):
        y = conv2d_resample(x, self.weight * self.weight_gain, f=self.resample_filter,
                            up=self.up, down=self.down, padding=self.padding)
        act_gain = _ACTS[self.activation][1] * gain
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(y, self.bias, act=self.activation, gain=act_gain, clamp=clamp)


class ModulatedConv2d(nn.Module):
    """Style-modulated conv: the affine map of the style scales the input
    channels of the weight, then demodulation rescales each output channel
    by rsqrt(sum w^2 + 1e-8). Samples run as one grouped conv."""

    def __init__(self, in_channels, features, kernel_size, style_dim, demodulate=True,
                 up=1, down=1, resample_filter=(1, 3, 3, 1)):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_channels, k, k))
        self.affine = FullyConnectedLayer(style_dim, in_channels, bias_init=1.0)
        self.demodulate, self.up, self.down = demodulate, up, down
        self.padding = k // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * k * k)
        _filter_buffer(self, resample_filter)

    @torch.no_grad()
    def init_parameters(self, generator):
        self.weight.normal_(generator=generator)

    def forward(self, x, style):
        b, h, w, cin = x.shape
        s = self.affine(style)  # (B, Cin)
        wt = self.weight[None] * self.weight_gain * s[:, None, :, None, None]  # B O I k k
        if self.demodulate:
            d = torch.rsqrt(wt.square().sum(dim=(2, 3, 4)) + 1e-8)  # (B, O)
            wt = wt * d[:, :, None, None, None]
        # samples side by side in the channel axis, one conv group each
        xg = x.permute(1, 2, 0, 3).reshape(1, h, w, b * cin)
        y = conv2d_resample(xg, wt.reshape((-1,) + tuple(wt.shape[2:])), f=self.resample_filter,
                            up=self.up, down=self.down, padding=self.padding, groups=b)
        ho, wo = y.shape[1:3]
        return y.reshape(ho, wo, b, -1).permute(2, 0, 1, 3)


class StyleConv(nn.Module):
    """ModulatedConv2d + noise + fused bias/act. Noise: ``"const"`` adds the
    stored ``noise_const`` plane, ``"random"`` a fresh normal plane from the
    caller's ``torch.Generator``, ``"none"`` nothing; each scaled by the
    learned ``noise_strength``."""

    def __init__(self, in_channels, features, style_dim, resolution, kernel_size=3, up=1,
                 use_noise=True, activation="lrelu", conv_clamp=None, demodulate=True):
        super().__init__()
        self.conv = ModulatedConv2d(in_channels, features, kernel_size, style_dim,
                                    demodulate=demodulate, up=up)
        self.use_noise = use_noise
        if use_noise:
            self.noise_strength = nn.Parameter(torch.empty(()))
            self.register_buffer("noise_const", torch.empty(resolution, resolution))
        self.bias = nn.Parameter(torch.empty(features))
        self.activation, self.conv_clamp = activation, conv_clamp

    @torch.no_grad()
    def init_parameters(self, generator):
        if self.use_noise:
            self.noise_strength.zero_()
            self.noise_const.normal_(generator=generator)
        self.bias.zero_()

    def forward(self, x, style, noise_mode="random", gain=1.0, generator=None):
        x = self.conv(x, style)
        if self.use_noise and noise_mode != "none":
            if noise_mode == "random":
                if generator is None:
                    raise ValueError("noise_mode='random' needs a torch.Generator")
                noise = torch.randn(x.shape[:3] + (1,), generator=generator,
                                    device=x.device, dtype=x.dtype)
            else:
                noise = self.noise_const[None, :, :, None]
            x = x + noise * self.noise_strength
        act_gain = _ACTS[self.activation][1] * gain
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=clamp)


class ToRGB(nn.Module):
    """Modulated 1x1 conv to image channels, with the upsampled skip image
    added."""

    def __init__(self, in_channels, features, style_dim, kernel_size=1, conv_clamp=None):
        super().__init__()
        self.conv = ModulatedConv2d(in_channels, features, kernel_size, style_dim,
                                    demodulate=False)
        self.bias = nn.Parameter(torch.empty(features))
        self.conv_clamp = conv_clamp
        _filter_buffer(self, (1, 3, 3, 1))

    @torch.no_grad()
    def init_parameters(self, generator):
        self.bias.zero_()

    def forward(self, x, style, skip=None):
        out = bias_act(self.conv(x, style), self.bias, clamp=self.conv_clamp)
        if skip is not None:
            if skip.shape != out.shape:
                skip = upsample2d(skip, self.resample_filter)
            out = out + skip
        return out


class MappingNet(nn.Module):
    """z -> w: 2nd-moment normalization, ``num_layers`` lrelu FCs, broadcast
    to ``num_ws`` and truncation toward the ``w_avg`` buffer, of the first
    ``truncation_cutoff`` ws where it is set. ``update_w_avg`` first moves
    ``w_avg`` toward the batch's mean w, in place (the JAX package's update
    of its mutable "w_stats"): w_avg = mean + beta (w_avg - mean)."""

    def __init__(self, z_dim, w_dim, num_ws, num_layers=8, lr_multiplier=0.01,
                 w_avg_beta=0.995):
        super().__init__()
        self.num_ws, self.num_layers, self.w_avg_beta = num_ws, num_layers, w_avg_beta
        for i in range(num_layers):
            self.add_module(f"fc{i}", FullyConnectedLayer(
                z_dim if i == 0 else w_dim, w_dim, activation="lrelu",
                lr_multiplier=lr_multiplier))
        self.register_buffer("w_avg", torch.empty(w_dim))

    @torch.no_grad()
    def init_parameters(self, generator):
        self.w_avg.zero_()

    def forward(self, z, truncation_psi=1.0, truncation_cutoff=None, update_w_avg=False):
        x = normalize_2nd_moment(z.float())
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        if update_w_avg:
            with torch.no_grad():
                mean = x.detach().mean(dim=0)
                self.w_avg.copy_(mean + self.w_avg_beta * (self.w_avg - mean))
        ws = x[:, None].expand(-1, self.num_ws, -1)
        if truncation_psi != 1.0:
            if truncation_cutoff is None:
                ws = self.w_avg + truncation_psi * (ws - self.w_avg)
            else:
                trunc = self.w_avg + truncation_psi * (ws[:, :truncation_cutoff] - self.w_avg)
                ws = torch.cat([trunc, ws[:, truncation_cutoff:]], dim=1)
        return ws
