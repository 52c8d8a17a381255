"""Image-space helpers: resize, gaussian blur, flow-edge extraction
(counterpart of waldo_tpu/ops/image.py).

Channel-last layout ((..., H, W, C)). ``resize`` is bilinear with
half-pixel centers and no antialiasing, i.e. ``F.interpolate(mode=
"bilinear", align_corners=False)`` at an explicit output size, for both up
and down scaling. The blur and the edge filters are the losses'; their
convolutions run in full float32 (``exact_float32``).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


def resize(x: torch.Tensor, scale_factor: float = None, shape=None) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to ``shape`` or by ``scale_factor``
    (output size int(H * s), int(W * s))."""
    if scale_factor is not None and scale_factor == 1:
        return x
    h, w, c = x.shape[-3:]
    if shape is None:
        shape = (int(h * scale_factor), int(w * scale_factor))
    shape = tuple(int(s) for s in shape)
    if shape == (h, w):
        return x
    lead = x.shape[:-3]
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=shape, mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(tuple(lead) + shape + (c,))


@contextlib.contextmanager
def exact_float32():
    """Float32 convolutions in full float32 on the card: cuDNN's default
    TF32 keeps ~3 decimal digits, which would move the losses' hard
    thresholds (a blurred one-hot layout against 0.999, a flow edge against
    flow_thresh) and the grid inversion's hole fill. The JAX package runs
    these convolutions at ``Precision.HIGHEST``."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _torchvision_gaussian_1d(kernel_size: int, sigma: float, device) -> torch.Tensor:
    """1-D gaussian as in torchvision's GaussianBlur, float32, made on
    ``device`` (a copy from the host would wait for the queued work)."""
    half = (kernel_size - 1) * 0.5
    x = torch.linspace(-half, half, kernel_size, dtype=torch.float64, device=device)
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).float()


def gaussian_blur(x: torch.Tensor, sigma: float = 3.0, kernel_size: int = 23) -> torch.Tensor:
    """Separable gaussian blur on (..., H, W, C) with reflect padding, along H
    first, then along W."""
    g = _torchvision_gaussian_1d(kernel_size, sigma, x.device).to(x.dtype)
    lead = tuple(x.shape[:-3])
    h, w, c = x.shape[-3:]
    p = kernel_size // 2
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.pad(y, (p, p, p, p), mode="reflect")
    with exact_float32():
        y = F.conv2d(y, g.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
        y = F.conv2d(y, g.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return y.permute(0, 2, 3, 1).reshape(lead + (h, w, c))


class EdgeExtractor:
    """Flow-edge magnitude and dominant-flow mask (counterpart of
    ``EdgeExtractor`` in waldo_tpu/ops/image.py): flow (..., H, W, C) ->
    (edge (..., H, W, 1), dominant (..., H, W, 1))."""

    def __init__(self, kernel_size: int = 3):
        if kernel_size % 2 != 1:
            raise ValueError(f"the edge kernel size must be odd, got {kernel_size}")
        k = self.k = kernel_size
        self.max_edge = math.sqrt(32.0)
        self.mean_kernel = np.ones((1, 1, k, k), np.float32) / (k * k)
        s = np.arange(k, dtype=np.float64) - k // 2
        sx, sy = s.reshape(-1, 1), s.reshape(1, -1)
        sum_xy = sx ** 2 + sy ** 2
        sum_xy[sum_xy == 0] = 1.0
        sobel_x = (sx / sum_xy).astype(np.float32)
        sobel_y = (sy / sum_xy).astype(np.float32)
        # two outputs (x- and y-derivative) of one input channel
        self.sobel_kernel = np.stack([sobel_x, sobel_y])[:, None]
        self._on_device = {}  # (device, dtype) -> the two kernels, copied once

    def _kernels(self, device, dtype):
        key = (device, dtype)
        if key not in self._on_device:
            self._on_device[key] = tuple(torch.as_tensor(k, device=device, dtype=dtype)
                                         for k in (self.mean_kernel, self.sobel_kernel))
        return self._on_device[key]

    def __call__(self, flow: torch.Tensor, eps: float = 1e-6):
        lead = tuple(flow.shape[:-3])
        h, w, c = flow.shape[-3:]
        x = flow.reshape(-1, h, w, c).permute(0, 3, 1, 2)  # b c h w
        b = x.shape[0]
        p = self.k // 2
        xc = F.pad(x.reshape(b * c, 1, h, w), (p, p, p, p), mode="reflect")
        dt = flow.dtype
        mean_kernel, sobel_kernel = self._kernels(flow.device, dt)
        with exact_float32():
            mean_flow = F.conv2d(xc, mean_kernel)
            edge = F.conv2d(xc, sobel_kernel)
        mean_norm = (mean_flow.reshape(b, c, h, w) ** 2).sum(dim=1)
        flow_norm = (x ** 2).sum(dim=1)
        dominant = (flow_norm > mean_norm).to(dt)[..., None]
        edge = torch.sqrt((edge ** 2).sum(dim=1) + eps) / self.max_edge  # (b*c, h, w)
        edge = 1.0 - torch.prod(1.0 - edge.reshape(b, c, h, w), dim=1)
        return (edge[..., None].reshape(lead + (h, w, 1)),
                dominant.reshape(lead + (h, w, 1)))
