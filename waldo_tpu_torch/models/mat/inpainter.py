"""MatInpainter: MAT inference on 512 crops (counterpart of
waldo_tpu/models/mat/inpainter.py).

Square inputs are resized to the net's resolution; other inputs are resized
to resolution x 2*resolution and run as three overlapping crops, blended by
triangular weights. ``mask`` is 1 where content must be synthesized (the net
receives 1 - mask as its keep-mask). The net runs with truncation 0.5 and
``noise_mode="const"``; each call draws its z from a ``torch.Generator`` on
the inpainter's device.

Weights: ``weights_path`` names a ``.npz`` in the JAX package's layout (a
``params`` entry holding the flax variables ``params``, ``noise_const`` and
``w_stats`` of its ``Generator``), carried across by
``waldo_tpu_torch.convert.mat_from_jax``. Without one the net has seeded
random weights. Converting the reference's pickle is not ported.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...nn import init_module
from ...ops import resize
from ...utils.profiling import annotate
from ...utils import resolve_device
from .mat import Generator


def expand_mask(mask: torch.Tensor, num: int = 1) -> torch.Tensor:
    """Binary 4-neighbourhood dilation of (..., H, W, 1) masks, ``num``
    times; any leading dims; in the mask's dtype."""
    lead = tuple(mask.shape[:-3])
    h, w, c = mask.shape[-3:]
    m = (mask > 0.5).reshape(-1, h, w, c)
    for _ in range(num):
        m = (m
             | F.pad(m[:, :-1], (0, 0, 0, 0, 1, 0))
             | F.pad(m[:, 1:], (0, 0, 0, 0, 0, 1))
             | F.pad(m[:, :, :-1], (0, 0, 1, 0))
             | F.pad(m[:, :, 1:], (0, 0, 0, 1)))
    return m.reshape(lead + (h, w, c)).to(mask.dtype)


class MatInpainter:
    def __init__(self, weights_path: Optional[str] = None, resolution: int = 512,
                 device="cuda", seed: int = 0):
        self.res = resolution
        self.device = resolve_device(device)
        self.net = Generator(img_resolution=resolution)
        if weights_path:
            from ...convert import mat_from_jax

            if not os.path.exists(weights_path):
                raise FileNotFoundError(f"no MAT weights at {weights_path}")
            data = np.load(weights_path, allow_pickle=True)
            mat_from_jax(data["params"].item(), self.net)
        else:
            init_module(self.net, torch.Generator().manual_seed(seed))
        self.net.to(self.device).eval()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.calls = 0  # Generator forwards run, one per crop

    def _next_z(self, b):
        return torch.randn((b, 512), generator=self.generator, device=self.device)

    def _apply(self, x, m, z):
        self.calls += 1
        with annotate("mat/generator"):
            return self.net(x, m, z, truncation_psi=0.5, noise_mode="const")

    @torch.inference_mode()
    def __call__(self, x, mask, exp=True, is_masked=True):
        """x (B,H,W,3) in [-1,1]; mask (B,H,W,1) with 1 = hole to fill.
        Computes in float32 (the JAX package promotes a bf16 frame to the
        net's float32 at its first product)."""
        x, mask = x.float(), mask.float()
        b, h, w, _ = x.shape
        if h == w:
            h0 = w0 = self.res
        else:
            h0, w0 = self.res, self.res * 2
        xi, mi = x, mask
        if (h, w) != (h0, w0):
            xi = resize(x, shape=(h0, w0))
            mi = (resize(mask, shape=(h0, w0)) > 0.5).to(x.dtype)
        if not is_masked:
            xi = (1 - mi) * xi
        if h == w:
            m = expand_mask(mi, 3) if exp else mi
            x2 = self._apply(xi, 1 - m, self._next_z(b))
        else:
            x2 = torch.zeros_like(xi)
            c = torch.zeros_like(mi)
            half = self.res // 2
            tri = torch.cat([torch.linspace(1, 100, half, device=x.device),
                             torch.linspace(100, 1, half, device=x.device)]).reshape(1, 1, -1, 1)
            for i in range(3):
                s = half * i
                xs = xi[:, :, s: s + self.res]
                ms = mi[:, :, s: s + self.res]
                m = expand_mask(ms, 3) if exp else ms
                x2s = self._apply(xs.contiguous(), (1 - m).contiguous(), self._next_z(b))
                x2[:, :, s: s + self.res] += x2s * tri
                c[:, :, s: s + self.res] += tri
            x2 = x2 / c
        out = x2 * mi + xi * (1 - mi)
        if (h, w) != (h0, w0):
            out = resize(out, shape=(h, w))
        return out
