"""Shape bookkeeping helpers (counterpart of waldo_tpu/utils/shapes.py)."""
from __future__ import annotations

import torch


def gather_time(x: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """Gather per-(ctx, pred) time pairs: x is (B, T, ...), ts is (B, Tc, Tp)
    int. Returns (B, Tc, Tp, ...)."""
    b = x.shape[0]
    flat = ts.reshape(b, -1).to(device=x.device, dtype=torch.long)
    idx = flat.reshape((b, -1) + (1,) * (x.dim() - 2)).expand(
        (b, flat.shape[1]) + tuple(x.shape[2:]))
    out = torch.gather(x, 1, idx)
    return out.reshape(tuple(ts.shape) + tuple(x.shape[2:]))
