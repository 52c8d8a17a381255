"""Thin-plate-spline warping as one matmul (counterpart of
waldo_tpu/ops/tps.py).

The (N+3)x(N+3) inverse kernel and the target-grid representation depend
only on the target control points and the output shape, so their product is
precomputed once on the host (float64 inverse) and each call is one
(HW, N+3) @ (N+3, 2) product per batch row.
"""
from __future__ import annotations

import numpy as np
import torch

from .grid import get_grid


def _kernel_distance_np(p1: np.ndarray, p2: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """phi(r) = 0.5 * r^2 * log(r^2 + eps)."""
    d = (
        (p1 ** 2).sum(-1)[:, None]
        + (p2 ** 2).sum(-1)[None, :]
        - 2.0 * p1 @ p2.T
    )
    return 0.5 * d * np.log(d + eps)


class TPSWarp:
    """Precomputed TPS mapping from N source control points to a dense grid.

    Calling the instance with src_pts (B, N, 2) returns the dense warp grid
    (B, H, W, 2) in float32. The matmul is float32; on a card it stays exact
    as long as TF32 matmuls are off (PyTorch's default)."""

    def __init__(self, tgt_height: int, tgt_width: int, tgt_pts, device="cuda"):
        tgt_pts = np.asarray(tgt_pts, dtype=np.float64).reshape(-1, 2)
        n = tgt_pts.shape[0]
        self.tgt_shape = (tgt_height, tgt_width)
        self.num_pts = n

        fk = np.zeros((n + 3, n + 3), dtype=np.float64)
        fk[:n, :n] = _kernel_distance_np(tgt_pts, tgt_pts)
        fk[:n, -3] = 1.0
        fk[-3, :n] = 1.0
        fk[:n, -2:] = tgt_pts
        fk[-2:, :n] = tgt_pts.T
        inverse_kernel = np.linalg.inv(fk)

        tgt_grid = get_grid(tgt_height, tgt_width).reshape(-1, 2).astype(np.float64)
        partial_repr = _kernel_distance_np(tgt_grid, tgt_pts)
        tgt_grid_repr = np.concatenate(
            [partial_repr, np.ones((tgt_grid.shape[0], 1)), tgt_grid], axis=1
        )
        # grid = repr @ (inv @ pad(src)) == (repr @ inv)[:, :N] @ src: the
        # three zero rows of the padded source drop out of the product
        proj = (tgt_grid_repr @ inverse_kernel)[:, :n]
        self.proj = torch.as_tensor(proj.astype(np.float32), device=device)

    def __call__(self, src_pts: torch.Tensor) -> torch.Tensor:
        """src_pts (B, N, 2) -> dense grid (B, H, W, 2)."""
        b = src_pts.shape[0]
        h, w = self.tgt_shape
        grid = torch.matmul(self.proj, src_pts.float())  # (B, HW, 2)
        return grid.reshape(b, h, w, 2)
