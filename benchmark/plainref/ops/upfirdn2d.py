"""upfirdn2d, channel-last (B, H, W, C): zero-insertion upsample, pad (or
crop), FIR filter, downsample, in plain PyTorch (StyleGAN2's
``torch_utils/ops/upfirdn2d.py`` reference path): zero insertion by reshape
and pad, ``F.pad`` (negative values crop), a depthwise ``F.conv2d`` with
the filter flipped (a true convolution), the downsample as its stride."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def setup_filter(taps) -> torch.Tensor:
    """The 2-D filter of 1-D ``taps``: their outer product, normalized to
    sum 1, float32."""
    f = np.asarray(taps, dtype=np.float64)
    f = np.outer(f, f)
    return torch.from_numpy((f / f.sum()).astype(np.float32))


def upfirdn2d(x: torch.Tensor, f=None, up: int = 1, down: int = 1, padding=(0, 0, 0, 0),
              gain: float = 1) -> torch.Tensor:
    """x (B, H, W, C); f (kh, kw) or None for the identity tap; padding
    (x0, x1, y0, y1). Returns (B, H', W', C)."""
    px0, px1, py0, py1 = padding
    b, h, w, c = x.shape
    if up > 1:
        x = F.pad(x.reshape(b, h, 1, w, 1, c), (0, 0, 0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, h * up, w * up, c)
    x = F.pad(x.permute(0, 3, 1, 2), (px0, px1, py0, py1))
    if f is None:
        if gain != 1:
            x = x * gain
        return x[:, :, ::down, ::down].permute(0, 2, 3, 1)
    f = f.to(dtype=x.dtype, device=x.device) * (gain ** (f.dim() / 2))
    kern = f.flip((0, 1))[None, None].expand(c, 1, *f.shape)
    return F.conv2d(x, kern, stride=down, groups=c).permute(0, 2, 3, 1)


def upsample2d(x: torch.Tensor, f: torch.Tensor, up: int = 2) -> torch.Tensor:
    fh, fw = f.shape
    p = ((fw + up - 1) // 2, (fw - up) // 2, (fh + up - 1) // 2, (fh - up) // 2)
    return upfirdn2d(x, f, up=up, padding=p, gain=up * up)
