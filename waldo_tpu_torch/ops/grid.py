"""Coordinate grids and small fixed kernels (counterpart of
waldo_tpu/ops/grid.py).

Normalized coordinates live in [-1, 1] with pixel centers at
x_j = -1 + (2j+1)/W, the `align_corners=False` convention. Grids are
channel-last, (H, W, 2) with (x, y) in the last axis. They are host numpy
constants; callers move them to their device once.
"""
from __future__ import annotations

import math

import numpy as np


def get_grid(height: int, width: int, dtype=np.float32) -> np.ndarray:
    """Pixel-center normalized grid, shape (H, W, 2), last axis = (x, y)."""
    x = np.linspace(-1.0 + 1.0 / width, 1.0 - 1.0 / width, width, dtype=np.float32)
    y = np.linspace(-1.0 + 1.0 / height, 1.0 - 1.0 / height, height, dtype=np.float32)
    xx = np.broadcast_to(x[None, :], (height, width))
    yy = np.broadcast_to(y[:, None], (height, width))
    return np.stack([xx, yy], axis=-1).astype(dtype)


def get_gaussian_kernel(k: int, sigma_div: float = 6.0) -> np.ndarray:
    """Normalized k x k gaussian kernel."""
    coords = np.arange(k, dtype=np.float64)
    mean = (k - 1) / 2.0
    sigma = k / sigma_div
    var = sigma ** 2
    g1 = np.exp(-((coords - mean) ** 2) / (2 * var))
    g = np.outer(g1, g1) / (2.0 * math.pi * var)
    g = g / g.sum()
    return g.astype(np.float32)


def get_circle(shape, p: float = 1.0) -> np.ndarray:
    """Binary circle mask (H, W)."""
    h, w = shape
    x = np.abs(np.arange(w)[None, :] - w / 2)
    y = np.abs(np.arange(h)[:, None] - h / 2)
    r = np.sqrt(x ** 2 + y ** 2)
    return (r < p * min(h, w) / 2).astype(np.float32)
