"""Warp-grid inversion (counterpart of waldo_tpu/ops/inverse_warp.py).

``InverseWarp.__call__`` is the forward-scatter inversion with the
reference's dilate-and-fill holes (the training configs' numerics);
``InverseWarp.iterative`` the gather-based fixed-point inversion (the
flagship predict's, ``fast_inverse_warp``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .grid import get_gaussian_kernel, get_grid
from .grid_sample import grid_sample
from .image import exact_float32, resize


def _neighbor_any(mask: torch.Tensor) -> torch.Tensor:
    """4-neighbourhood OR of a (B, H, W) boolean mask, zero-filled."""
    m = F.pad(mask, (1, 1, 1, 1))
    return m[:, :-2, 1:-1] | m[:, 2:, 1:-1] | m[:, 1:-1, :-2] | m[:, 1:-1, 2:]


class InverseWarp:
    def __init__(self, src_height, src_width, tgt_height, tgt_width, device="cuda"):
        self.src_shape = (src_height, src_width)
        self.tgt_shape = (tgt_height, tgt_width)
        # the hole fill's 3x3 gaussian
        self.kernel = torch.as_tensor(get_gaussian_kernel(3), device=device)
        self.src_grid = torch.as_tensor(get_grid(src_height, src_width), device=device)
        self.tgt_grid = torch.as_tensor(get_grid(tgt_height, tgt_width), device=device)

    def __call__(self, src_grid: torch.Tensor, niter: int = 5, erode: bool = True
                 ) -> torch.Tensor:
        """Invert dense forward grids by scatter and hole filling:
        src_grid (B, Hs, Ws, 2) maps target -> source; the result (B, H, W, 2)
        maps source -> target, with unresolved pixels pushed far out of
        bounds (2W, 2H in pixels) so that a later zero-padded sample reads 0
        there.

        Each displacement, rounded half to even as ``jnp.round`` rounds it,
        lands on one destination pixel; where several land on one, the
        lowest source index wins (the reference's stable sort). A scatter-min
        of the source index finds each destination's winner, and the
        destinations then gather their winners' values, so no two writes
        meet and the result is deterministic on the card. Gradients reach
        ``src_grid`` through the gathered displacements and the 5-step
        dilate-and-average fill, as in the JAX package."""
        b, hs, ws, _ = src_grid.shape
        h, w = self.tgt_shape
        dev = src_grid.device

        dsrc = src_grid.float() - self.src_grid[None]
        if (hs, ws) != (h, w):
            dsrc = resize(dsrc, shape=(h, w))
        dx = dsrc[..., 0].reshape(b, -1) * (w / 2.0)
        dy = dsrc[..., 1].reshape(b, -1) * (h / 2.0)

        hw = h * w
        pos = torch.arange(hw, device=dev)
        col = (pos % w).float()
        row = torch.div(pos, w, rounding_mode="floor").float()
        with torch.no_grad():
            xg = torch.round(col[None] + dx).long()
            yg = torch.round(row[None] + dy).long()
            oob = (xg < 0) | (yg < 0) | (xg > w - 1) | (yg > h - 1)
            dest = torch.where(oob, hw, yg * w + xg)  # (B, HW); slot hw takes the misses
            winner = torch.full((b, hw + 1), hw, dtype=torch.long, device=dev)
            winner.scatter_reduce_(1, dest, pos[None].expand(b, hw), "amin")
            winner = winner[:, :hw]
            mask = winner < hw
            src = winner.clamp(max=hw - 1)
        zero = dx.new_zeros(())
        inv_dx = torch.where(mask, -dx.gather(1, src), zero).reshape(b, h, w)
        inv_dy = torch.where(mask, -dy.gather(1, src), zero).reshape(b, h, w)
        mask = mask.reshape(b, h, w)

        # a margin that the fill and the erosion cannot reach across
        p = niter + 1
        inv_dx = F.pad(inv_dx, (p, p, p, p))
        inv_dy = F.pad(inv_dy, (p, p, p, p))
        mask = F.pad(mask, (p, p, p, p))

        k = self.kernel.shape[0]
        kern3 = self.kernel.reshape(1, 1, k, k).expand(3, 1, k, k)
        for _ in range(niter):
            new_mask = _neighbor_any(mask) & ~mask
            # one depthwise convolution over (dx, dy, mask) instead of three
            stacked = torch.stack([inv_dx, inv_dy, mask.float()], dim=1)
            with exact_float32():
                filt = F.conv2d(stacked, kern3, padding=k // 2, groups=3)
            fx, fy, s = filt[:, 0], filt[:, 1], filt[:, 2]
            s = torch.where(s == 0, torch.ones_like(s), s)
            inv_dx = torch.where(new_mask, fx / s, inv_dx)
            inv_dy = torch.where(new_mask, fy / s, inv_dy)
            mask = mask | new_mask

        if erode:
            for _ in range(niter):
                border = _neighbor_any(~mask) & mask
                mask = mask & ~border

        inv_dx = torch.where(mask, inv_dx, torch.full_like(inv_dx, 2.0 * w))[:, p:-p, p:-p]
        inv_dy = torch.where(mask, inv_dy, torch.full_like(inv_dy, 2.0 * h))[:, p:-p, p:-p]
        dtgt = torch.stack([inv_dx * (2.0 / w), inv_dy * (2.0 / h)], dim=-1)
        return self.tgt_grid[None] + dtgt

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
