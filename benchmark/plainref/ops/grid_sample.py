"""Bilinear grid sampling with ``F.grid_sample`` semantics (bilinear, zero
padding, align_corners=False), channel-last: the plain versions of the
port's samplers, the only ones here.

Layout: image (B, H, W, C), grid (B, Ho, Wo, 2) with (x, y) in [-1, 1].

Where the program sends a CUDA tensor to one of its hand kernels, this copy
tells an observer, when one is installed (``observe``), which kernel the
program would launch on these inputs: ``observer(kind, **tensors)`` with
kind "k1" (the fused alpha_ctx warp and its pre-pass), "k2" (a shared grid,
``tp_sz`` rows a texture), "k2pc" (per-channel grids and their pre-pass),
"k2_bwd" / "k2pc_bwd" (their backwards, from a hook on the sample's output
gradient). The benchmark counts the kernels' bytes from them. Without an
observer nothing is told and nothing is computed for it.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from .grid import get_grid

_observers = []


@contextlib.contextmanager
def observe(observer: Callable):
    """Tell ``observer`` of every sample that the program would hand a kernel
    inside the block."""
    _observers.append(observer)
    try:
        yield observer
    finally:
        _observers.remove(observer)


def _tell(kind, out: Optional[torch.Tensor] = None, **tensors):
    if not _observers or not tensors[next(iter(tensors))].is_cuda:
        return
    for obs in _observers:
        obs(kind, **tensors)
    if out is not None and out.requires_grad:
        def bwd(grad, tensors=tensors):
            for obs in _observers:
                obs(kind + "_bwd", grad_out=grad.detach(), **tensors)
        out.register_hook(bwd)


def in_kernel_envelope(img_shape, grid_shape) -> bool:
    """Whether the program sends a generic sample of a texture ``img_shape``
    (B, H, W, C) along grids ``grid_shape`` to its kernel."""
    src = img_shape[-3] * img_shape[-2]
    out_px = grid_shape[-3] * grid_shape[-2]
    return (src * img_shape[-1] >= (1 << 19) and src <= (1 << 22)
            and out_px >= (1 << 15) and img_shape[0] <= 256)


def grid_sample_plain(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample img (B,H,W,C) at grid (B,Ho,Wo,2) -> (B,Ho,Wo,C) in img's dtype,
    computed in float32 by ``F.grid_sample``."""
    out = F.grid_sample(img.permute(0, 3, 1, 2).float(), grid.float(),
                        mode="bilinear", padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1).to(img.dtype)


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The generic sampler (the program's kernel in batch mode inside
    ``in_kernel_envelope`` on the card)."""
    out = grid_sample_plain(img, grid)
    if in_kernel_envelope(img.shape, grid.shape):
        _tell("k2", out, img=img.detach(), grid=grid.detach(), tp_sz=1,
              need_img=img.requires_grad)
    return out


def grid_sample_multigrid(img: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """Per-channel-grid sampling: out[..., k] samples img[..., k] along
    grids[:, k]. img (B,H,W,C), grids (B,C,Ho,Wo,2) -> (B,Ho,Wo,C)."""
    b, h, w, c = img.shape
    img_f = img.permute(0, 3, 1, 2).reshape(b * c, h, w, 1)
    out = grid_sample_plain(img_f, grids.reshape((b * c,) + tuple(grids.shape[2:])))
    out = out.reshape((b, c) + tuple(out.shape[1:3])).permute(0, 2, 3, 1)
    _tell("k2pc", out, img=img.detach(), grids=grids.detach(), need_img=img.requires_grad)
    return out


def grid_sample_ctx(img: torch.Tensor, grid: torch.Tensor, *, tp_sz: int) -> torch.Tensor:
    """Shared-texture context-fusion sampling: grid row i samples img row
    i // tp_sz. img (F,H,W,C), grid (F*tp_sz,Ho,Wo,2) -> (F*tp_sz,Ho,Wo,C)."""
    f = img.shape[0]
    if grid.shape[0] != f * tp_sz:
        raise ValueError(f"grid rows {grid.shape[0]} != {f} textures * tp_sz {tp_sz}")
    rep = img if tp_sz == 1 else img.repeat_interleave(tp_sz, dim=0)
    out = grid_sample_plain(rep, grid)
    _tell("k2", out, img=img.detach(), grid=grid.detach(), tp_sz=tp_sz,
          need_img=img.requires_grad)
    return out


def warp_alpha_ctx(alpha_u: torch.Tensor, grids: torch.Tensor, occ: torch.Tensor,
                   is_obj: Optional[torch.Tensor], *, tp_sz: int, tcp: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused predict-path warp composed of plain operations (sample +
    ghost mask + disocc max + prediction-time occlusion product +
    alpha-weighted flow reduction), float32.

    alpha_u (F, H, W, C), grids (N, C, gh, gw, 2) with N = F*tp_sz (row n
    samples frame n // tp_sz), occ (N, C, C), is_obj (B*Tp, C, gh, gw) or
    None. Returns (alpha_occ (N, gh, gw, C), disocc (N, gh, gw, 1), flow
    (N, gh, gw, 2) = sum_j alpha_occ_j * (g_j - base_grid))."""
    f, h, w, c = alpha_u.shape
    n, gc, gh, gw, _ = grids.shape
    if gc != c or n != f * tp_sz:
        raise ValueError(f"alpha {tuple(alpha_u.shape)} and grids {tuple(grids.shape)} "
                         f"disagree for tp_sz {tp_sz}")
    _tell("k1", alpha=alpha_u.detach(), grids=grids.detach(), occ=occ.detach(),
          is_obj=None if is_obj is None else is_obj.detach(), tp_sz=tp_sz, tcp=tcp)
    a_g = alpha_u.float().repeat_interleave(tp_sz, dim=0)
    b_, _, _, _ = a_g.shape
    img_f = a_g.permute(0, 3, 1, 2).reshape(b_ * c, h, w, 1)
    sam = grid_sample_plain(img_f, grids.reshape((b_ * c,) + tuple(grids.shape[2:])))
    sam = sam.reshape((b_, c) + tuple(sam.shape[1:3])).permute(0, 2, 3, 1)
    if is_obj is not None:
        k = torch.arange(n, device=alpha_u.device)
        rows = (k // tcp) * tp_sz + k % tp_sz
        sam = sam * is_obj[rows].permute(0, 2, 3, 1).to(sam.dtype)
    dis = sam.amax(dim=-1, keepdim=True)
    o = occ.float()
    occp = torch.ones_like(sam)
    for i in range(c):
        occp = occp * (1.0 - sam[..., i:i + 1] * o[:, None, None, i, :])
    a_occ = occp * sam
    base = torch.as_tensor(get_grid(gh, gw), device=alpha_u.device)
    flow = torch.zeros((n, gh, gw, 2), dtype=torch.float32, device=alpha_u.device)
    for j in range(c):
        flow = flow + a_occ[..., j:j + 1] * (grids[:, j].float() - base)
    return a_occ, dis, flow
