"""upfirdn2d: zero-insertion upsample -> pad (or crop) -> FIR filter ->
downsample (counterpart of waldo_tpu/ops/upfirdn2d.py).

Channel-last layout (B, H, W, C). The JAX package runs the chain as one XLA
convolution, not a Pallas kernel, so here it stays plain PyTorch: zero
insertion by reshape and pad, ``F.pad`` (negative values crop), a depthwise
``F.conv2d`` with the filter flipped (a true convolution), and the
downsample as the convolution's stride. Zero insertion leaves ``up - 1``
trailing zeros after every sample, the reference's layout; the JAX code
reaches the same by adding ``up - 1`` to the high-side padding.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def setup_filter(f, normalize=True, flip_filter=False, gain=1) -> np.ndarray:
    """A 2-D FIR filter as float32 numpy (1-D taps become their outer
    product; always non-separable)."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float64)
    if f.ndim == 0:
        f = f[None]
    if f.ndim == 1:
        f = np.outer(f, f)
    if f.ndim != 2:
        raise ValueError(f"a filter has 1 or 2 dimensions, got {f.ndim}")
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return np.asarray(f.copy(), dtype=np.float32)


def _parse2(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _parse4(v):
    """-> (padx0, padx1, pady0, pady1), x-axis first like the reference."""
    if isinstance(v, int):
        return v, v, v, v
    if len(v) == 2:
        return v[0], v[0], v[1], v[1]
    return tuple(v)


def _filter_shape(f):
    return tuple(f.shape) if f is not None else (1, 1)


def upfirdn2d(x: torch.Tensor, f, up=1, down=1, padding=0, flip_filter=False,
              gain=1) -> torch.Tensor:
    """x (B, H, W, C); f (kh, kw) numpy or tensor taps, or None for the
    identity tap. Returns (B, H', W', C). The zero insertion runs on the
    channel-last tensor and the rest on its channel-first view, which keeps
    channel-last memory for cuDNN."""
    upx, upy = _parse2(up)
    downx, downy = _parse2(down)
    padx0, padx1, pady0, pady1 = _parse4(padding)
    b, h, w, c = x.shape
    if upx > 1 or upy > 1:
        x = F.pad(x.reshape(b, h, 1, w, 1, c), (0, 0, 0, upx - 1, 0, 0, 0, upy - 1))
        x = x.reshape(b, h * upy, w * upx, c)
    x = F.pad(x.permute(0, 3, 1, 2), (padx0, padx1, pady0, pady1))
    if f is None:
        if gain != 1:
            x = x * gain
        if downx > 1 or downy > 1:
            x = x[:, :, ::downy, ::downx]
        return x.permute(0, 2, 3, 1)
    if not isinstance(f, torch.Tensor):
        f = torch.from_numpy(np.ascontiguousarray(f))
    f = f.to(dtype=x.dtype, device=x.device) * (gain ** (f.dim() / 2))
    if not flip_filter:
        f = f.flip((0, 1))
    kern = f[None, None].expand(c, 1, *f.shape)
    return F.conv2d(x, kern, stride=(downy, downx), groups=c).permute(0, 2, 3, 1)


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    padx0, padx1, pady0, pady1 = _parse4(padding)
    fh, fw = f.shape
    p = (padx0 + fw // 2, padx1 + (fw - 1) // 2, pady0 + fh // 2, pady1 + (fh - 1) // 2)
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    upx, upy = _parse2(up)
    padx0, padx1, pady0, pady1 = _parse4(padding)
    fh, fw = _filter_shape(f)
    p = (
        padx0 + (fw + upx - 1) // 2,
        padx1 + (fw - upx) // 2,
        pady0 + (fh + upy - 1) // 2,
        pady1 + (fh - upy) // 2,
    )
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    downx, downy = _parse2(down)
    padx0, padx1, pady0, pady1 = _parse4(padding)
    fh, fw = _filter_shape(f)
    p = (
        padx0 + (fw - downx + 1) // 2,
        padx1 + (fw - downx) // 2,
        pady0 + (fh - downy + 1) // 2,
        pady1 + (fh - downy) // 2,
    )
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
