"""Image-space resize (counterpart of ``resize`` in waldo_tpu/ops/image.py).

Channel-last layout ((..., H, W, C)). Bilinear with half-pixel centers and
no antialiasing, i.e. ``F.interpolate(mode="bilinear",
align_corners=False)`` at an explicit output size, for both up and down
scaling.
"""
from __future__ import annotations

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
