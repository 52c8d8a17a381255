"""Roofline arithmetic of the port's hand kernels (copied from the bound
functions of ``chip_smoke.py``: ``bound``, ``k2_fwd_bound``,
``k2_bwd_bound``, ``tapped_texels`` and the rows of K1, K2', the pre-pass
and the backwards).

A kernel's bound is the least time the card could take: its bytes over the
memory rate or its float32 operations over the float32 peak, whichever is
larger. Each input byte counts once and each output byte once; where a
kernel skips by data (the samples whose bilinear footprint misses their
plane's nonzero box, the texels no tap reaches) only what these inputs
need counts: the distinct texels the live taps read.

``KernelBounds`` is an observer for the reference's samplers
(``plainref.ops.grid_sample.observe``): told of each sample that the
program hands a kernel, it adds that launch's bound and counts the
launches the program makes for it, by the program's counter names.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

# NVIDIA's H100 SXM data sheet (the NVIDIA H100 80GB HBM3 the cells run on):
# HBM3 bytes/s and dense float32 flop/s outside the tensor cores
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12

# the port's hand kernels as the device trace names them (csrc/*.cu)
HAND_KERNELS = ("warp_alpha_ctx_kernel", "grid_sample_shared_kernel", "grid_sample_few_kernel",
                "grid_sample_per_channel_kernel", "grid_sample_shared_bwd_kernel",
                "grid_sample_per_channel_bwd_kernel", "plane_boxes_kernel", "empty_boxes_kernel")


def is_hand_kernel(name: str) -> bool:
    return any(k in name for k in HAND_KERNELS)


def bound_ms(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BPS, nops / FP32_FLOPS) * 1e3


def _top_left(g: torch.Tensor, size: int) -> torch.Tensor:
    """The kernels' top-left tap index along one axis (csrc/bilinear.cuh)."""
    i = (g.float() + 1.0) * (size * 0.5) - 0.5
    return torch.floor(i.clamp(-2.0, size + 1.0)).long()


def plane_boxes(tex: torch.Tensor) -> torch.Tensor:
    """Each (frame, channel) plane's inclusive nonzero box (y0, y1, x0, x1),
    (H, -1, W, -1) where the plane is all zero; tex (F, H, W, C)."""
    nz = tex.permute(0, 3, 1, 2) != 0

    def span(any_along):
        idx = torch.arange(any_along.shape[-1], device=tex.device)
        return (torch.where(any_along, idx, any_along.shape[-1]).amin(dim=-1),
                torch.where(any_along, idx, -1).amax(dim=-1))

    y0, y1 = span(nz.any(dim=3))
    x0, x1 = span(nz.any(dim=2))
    return torch.stack([y0, y1, x0, x1], dim=-1)


def tapped_texels(grids: torch.Tensor, plane: torch.Tensor, h: int, w: int,
                  boxes: Optional[torch.Tensor] = None, alive: Optional[torch.Tensor] = None,
                  chunk: int = 16) -> int:
    """The distinct texels that the bilinear taps of grids (R, Ho, Wo, 2)
    read, row r reading texture plane ``plane[r]`` of h x w. With the
    planes' nonzero boxes (P, 4), a sample whose footprint misses its box
    reads none (csrc/bilinear.cuh: sample_boxed); with ``alive`` (R, Ho,
    Wo) bool, a sample where it is False reads none."""
    keys = []
    for r0 in range(0, grids.shape[0], chunk):
        g = grids[r0:r0 + chunk]
        x0, y0 = _top_left(g[..., 0], w), _top_left(g[..., 1], h)
        pl = plane[r0:r0 + chunk][:, None, None].expand_as(x0)
        live = torch.ones_like(x0, dtype=torch.bool)
        if boxes is not None:
            b = boxes[pl]
            live &= ~((x0 + 1 < b[..., 2]) | (x0 > b[..., 3]) | (y0 + 1 < b[..., 0])
                      | (y0 > b[..., 1]))
        if alive is not None:
            live &= alive[r0:r0 + chunk]
        if boxes is not None or alive is not None:
            x0, y0, pl = x0[live], y0[live], pl[live]
        for y in (y0, y0 + 1):
            for x in (x0, x0 + 1):
                inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                keys.append(((pl * h + y) * w + x)[inside])
        if sum(k.numel() for k in keys) > (1 << 26):
            keys = [torch.unique(torch.cat(keys))]
    return int(torch.unique(torch.cat(keys)).numel()) if keys else 0


class KernelBounds:
    """Sum of the bounds (ms) of the launches the program makes for the
    samples it is told of, and their count by the program's counter names."""

    def __init__(self):
        self.ms = 0.0
        self.launches: Counter = Counter()

    def __call__(self, kind, **t):
        getattr(self, "_" + kind)(**t)

    def _add(self, name, nbytes, nops):
        self.ms += bound_ms(nbytes, nops)
        self.launches[name] += 1

    def _prepass(self, tex):
        """csrc/planes.cu: the texture read, its planes written, the boxes."""
        f, h, w, c = tex.shape
        self._add("plane_boxes", 2 * tex.numel() * tex.element_size() + 16 * f * c, tex.numel())

    def _k1(self, alpha, grids, occ, is_obj, tp_sz, tcp):
        """The fused warp: the alpha texels the live taps read (planes shared
        by the tp_sz rows of a frame), the grids, occ and the ghost mask rows
        it reads, its three outputs written."""
        self._prepass(alpha)
        f, h, w, c = alpha.shape
        n, _, gh, gw, _ = grids.shape
        p = gh * gw
        boxes = plane_boxes(alpha).reshape(f * c, 4)
        rows = grids.reshape(n * c, gh, gw, 2)
        plane = ((torch.arange(n, device=grids.device) // tp_sz)[:, None] * c
                 + torch.arange(c, device=grids.device)[None, :]).reshape(-1)
        texels = tapped_texels(rows, plane, h, w, boxes)
        nbytes = 4 * (texels + n * c * p * 2 + n * c * c + n * p * (c + 3))
        nops = n * p * (3 * c * c + 32 * c)
        if is_obj is not None:
            nbytes += 4 * (n // tcp) * tp_sz * c * p
            nops += n * p * c
        self._add("warp_alpha_ctx", nbytes, nops)

    def _k2(self, img, grid, tp_sz, need_img):
        """The shared-grid sample: the texels the taps reach (every channel
        of each), the grid, the output."""
        f, h, w, c = img.shape
        n, ho, wo, _ = grid.shape
        es, p = img.element_size(), ho * wo
        plane = torch.arange(n, device=grid.device) // tp_sz
        texels = tapped_texels(grid, plane, h, w)
        self._add("grid_sample", es * (texels * c + n * p * c) + 8 * n * p, n * p * (16 + 8 * c))

    def _k2_bwd(self, img, grid, tp_sz, need_img, grad_out):
        """Its backward (grid gradient; the texture's too when asked): grad_out,
        the grid and grad_grid once, the texture channels a nonzero output
        gradient reads."""
        f, h, w, c = img.shape
        rows = grid.shape[0]
        live = (grad_out != 0).reshape(f, rows // f, -1, c).any(2).any(1)
        nbytes = 4 * (h * w * int(live.sum()) + 4 * grid[..., 0].numel() + grad_out.numel())
        if need_img:
            nbytes += 4 * img.numel()
        self._add("grid_sample_bwd", nbytes,
                  16 * grid[..., 0].numel() + 12 * int((grad_out != 0).sum()))

    def _k2pc(self, img, grids, need_img):
        """Per-channel grids: the pre-pass, then the texels the live taps read,
        the grids, the output."""
        self._prepass(img)
        f, h, w, c = img.shape
        n_s = f * c * grids.shape[2] * grids.shape[3]
        es = img.element_size()
        boxes = plane_boxes(img).reshape(f * c, 4)
        plane = torch.arange(f * c, device=grids.device)
        texels = tapped_texels(grids.reshape(f * c, *grids.shape[2:]), plane, h, w, boxes)
        self._add("grid_sample_per_channel", es * texels + (8 + es) * n_s, 24 * n_s)

    def _k2pc_bwd(self, img, grids, need_img, grad_out):
        """Its backward: the grids read and grad_grids written, grad_out, the
        planes' texels the live taps read and, when asked, grad_img written."""
        f, h, w, c = img.shape
        n_s = f * c * grids.shape[2] * grids.shape[3]
        boxes = plane_boxes(img).reshape(f * c, 4)
        plane = torch.arange(f * c, device=grids.device)
        alive = (grad_out != 0).permute(0, 3, 1, 2).reshape(f * c, *grids.shape[2:4])
        texels = tapped_texels(grids.reshape(f * c, *grids.shape[2:]), plane, h, w, boxes, alive)
        nbytes = 2 * 8 * n_s + 4 * n_s + 4 * texels + (4 * img.numel() if need_img else 0)
        self._add("grid_sample_per_channel_bwd", nbytes, 40 * n_s)
