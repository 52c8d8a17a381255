"""Warp-grid inversion (counterpart of waldo_tpu/ops/inverse_warp.py).

Only the gather-based fixed-point inversion (``InverseWarp.iterative``, the
flagship numerics) is ported; the forward-scatter ``__call__`` with its
dilate-and-fill holes is not ported yet.
"""
from __future__ import annotations

import torch

from .grid import get_grid
from .grid_sample import grid_sample


class InverseWarp:
    def __init__(self, src_height, src_width, tgt_height, tgt_width, device="cuda"):
        self.src_shape = (src_height, src_width)
        self.tgt_shape = (tgt_height, tgt_width)
        self.src_grid = torch.as_tensor(get_grid(src_height, src_width), device=device)
        self.tgt_grid = torch.as_tensor(get_grid(tgt_height, tgt_width), device=device)

    def iterative(self, src_grid: torch.Tensor, niter: int = 4, tol: float = 0.05
                  ) -> torch.Tensor:
        """Fixed-point inversion: solves G(q) = q - u(G(q)), u the forward
        displacement on the source lattice, by iterating v <- -u(q + v).
        Pixels whose last step moved more than ``tol`` (fold-overs,
        disocclusions) or that land outside [-1, 1] are pushed to 4.0, far
        out of bounds, so a later zero-padded sample reads 0 there.

        src_grid (B, Hs, Ws, 2) -> (B, H, W, 2). Every sample runs in float32
        (the JAX signature's "fast" precision rounds the early iterations to
        bf16 on the TPU's matrix unit; the port has no such schedule)."""
        if niter < 1:
            raise ValueError("iterative inversion needs >= 1 evaluation")
        b = src_grid.shape[0]
        h, w = self.tgt_shape
        u = src_grid.float() - self.src_grid[None]
        q = self.tgt_grid[None].expand(b, h, w, 2)
        v = torch.zeros_like(q)
        delta = q
        for _ in range(niter):
            v_new = -grid_sample(u, q + v)
            delta = v_new - v
            v = v_new
        bad = (delta.abs().amax(dim=-1, keepdim=True) > tol) | (
            (q + v).abs().amax(dim=-1, keepdim=True) > 1.0)
        return torch.where(bad, torch.full_like(v, 4.0), q + v)
