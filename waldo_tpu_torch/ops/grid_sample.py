"""Bilinear grid sampling with torch ``F.grid_sample`` semantics (bilinear,
zero padding, align_corners=False), channel-last (counterpart of
waldo_tpu/ops/grid_sample.py).

Layout: image (B, H, W, C), grid (B, Ho, Wo, 2) with (x, y) in [-1, 1].

``grid_sample``, ``grid_sample_multigrid``, ``grid_sample_ctx`` and
``warp_alpha_ctx`` are the samples of the ported paths. For each the plain
PyTorch version sits here (``*_plain``) and a CUDA tensor goes to the
hand-written kernel (ops/kernels): there is no fallback from a CUDA tensor
to the plain version. The generic ``grid_sample`` takes the kernel (K2 in
batch mode) exactly inside the JAX package's TPU routing envelope
(``in_kernel_envelope``) and is ``F.grid_sample`` outside it, as the JAX
package leaves those samples to XLA. The three samplers are differentiable:
on the card their backward is a hand-written kernel too
(csrc/grid_sample_bwd.cu, float32 only), on the CPU autograd runs through
``F.grid_sample``; both take torch's one-sided derivative where a sample
sits exactly on a texel centre. ``warp_alpha_ctx`` (the fused predict-path
warp) has no backward. ``plane_boxes_plain`` is the plain version of the
pre-pass that feeds the per-layer samples of the kernels, and
``tap_footprint_skips`` the kernels' exact test for a sample that is 0
without reading a texel (the TPU kernels' sparsity skip). The kernels and
the plain versions compute in float32: the JAX signatures' ``precision``
has no counterpart here, since "fast" sampling only decides where the
callers store bf16 maps.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .grid import get_grid
from .kernels import (grid_sample_bwd_cuda, grid_sample_cuda, grid_sample_per_channel_bwd_cuda,
                      grid_sample_per_channel_cuda, warp_alpha_ctx_cuda)


def in_kernel_envelope(img_shape, grid_shape) -> bool:
    """Whether a generic sample of a texture ``img_shape`` (B, H, W, C) along
    grids ``grid_shape`` goes to the kernel: the envelope in which the JAX
    package routes it to ``grid_sample_pallas`` on the TPU
    (waldo_tpu/ops/grid_sample.py, ``auto_impl``)."""
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


def _require_float32(img, grid, what):
    if img.dtype != torch.float32 and torch.is_grad_enabled() and (
            img.requires_grad or grid.requires_grad):
        raise TypeError(f"the {what} kernel's backward takes float32 textures only, got "
                        f"{img.dtype} with a gradient asked for")


class _GridSampleCuda(torch.autograd.Function):
    """Shared-grid sample (K2; ``tp_sz`` 1 is its batch mode) with the
    hand-written backward."""

    @staticmethod
    def forward(ctx, img, grid, tp_sz):
        ctx.tp_sz = tp_sz
        ctx.save_for_backward(img, grid)
        return grid_sample_cuda(img, grid, tp_sz)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        img, grid = ctx.saved_tensors
        g_img, g_grid = grid_sample_bwd_cuda(img, grid, grad.float().contiguous(), ctx.tp_sz,
                                             ctx.needs_input_grad[0])
        return g_img, g_grid if ctx.needs_input_grad[1] else None, None


def _grid_sample_kernel(img, grid, tp_sz):
    _require_float32(img, grid, "grid_sample")
    return _GridSampleCuda.apply(img.contiguous(), grid.float().contiguous(), tp_sz)


def grid_sample(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample img (B,H,W,C) at grid (B,Ho,Wo,2) -> (B,Ho,Wo,C) in img's dtype,
    computed in float32. The generic sampler: a CUDA tensor inside
    ``in_kernel_envelope`` (the training path's gathered context fusion)
    goes to the kernel in batch mode; every other sample (TPS inversion,
    layer_to_output, the small samples of the MAT post-processing) is
    ``F.grid_sample``."""
    if img.is_cuda and in_kernel_envelope(img.shape, grid.shape):
        return _grid_sample_kernel(img, grid, 1)
    return grid_sample_plain(img, grid)


def plane_boxes_plain(tex: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The samplers' pre-pass (csrc/planes.cu): tex (F, H, W, C) -> (planes
    (F, C, H, W) in tex's dtype, boxes (F, C, 4) int32), each plane's
    inclusive nonzero box (y0, y1, x0, x1), or (H, -1, W, -1) where the plane
    is all zero. A NaN counts as nonzero, -0.0 as zero."""
    planes = tex.permute(0, 3, 1, 2).contiguous()
    nz = planes != 0

    def span(any_along):
        idx = torch.arange(any_along.shape[-1], device=tex.device)
        return (torch.where(any_along, idx, any_along.shape[-1]).amin(dim=-1),
                torch.where(any_along, idx, -1).amax(dim=-1))

    y0, y1 = span(nz.any(dim=3))
    x0, x1 = span(nz.any(dim=2))
    return planes, torch.stack([y0, y1, x0, x1], dim=-1).to(torch.int32)


def tap_footprint_skips(grids: torch.Tensor, boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The kernels' sparsity test, in plain PyTorch: grids (R, C, gh, gw, 2)
    sampling planes of size h x w whose nonzero boxes are boxes (R, C, 4).
    True where the 2x2 bilinear footprint of a (row, layer, pixel) sample
    misses its plane's box, so that the sample is exactly 0 and the kernels
    read no texel for it (csrc/bilinear.cuh: top_left_tap, misses_box)."""
    def top_left(g, size):
        i = (g + 1.0) * (size * 0.5) - 0.5
        return torch.floor(i.clamp(-2.0, size + 1.0)).to(torch.int32)

    x0, y0 = top_left(grids[..., 0].float(), w), top_left(grids[..., 1].float(), h)
    b = boxes[:, :, None, None, :]
    return (x0 + 1 < b[..., 2]) | (x0 > b[..., 3]) | (y0 + 1 < b[..., 0]) | (y0 > b[..., 1])


def grid_sample_multigrid_plain(img: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """Per-channel grids: channels folded into the batch of ``F.grid_sample``."""
    b, h, w, c = img.shape
    img_f = img.permute(0, 3, 1, 2).reshape(b * c, h, w, 1)
    out = grid_sample_plain(img_f, grids.reshape((b * c,) + tuple(grids.shape[2:])))
    return out.reshape((b, c) + tuple(out.shape[1:3])).permute(0, 2, 3, 1)


class _MultigridSampleCuda(torch.autograd.Function):
    """Per-channel-grid sample (K2') with the hand-written backward, which
    reads the planes and boxes of the forward's pre-pass."""

    @staticmethod
    def forward(ctx, img, grids):
        out, planes, boxes = grid_sample_per_channel_cuda(img, grids)
        ctx.save_for_backward(planes, boxes, grids)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        planes, boxes, grids = ctx.saved_tensors
        g_img, g_grids = grid_sample_per_channel_bwd_cuda(
            planes, boxes, grids, grad.float().contiguous(), ctx.needs_input_grad[0])
        return g_img, g_grids if ctx.needs_input_grad[1] else None


def grid_sample_multigrid(img: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """Per-channel-grid sampling: out[..., k] samples img[..., k] along
    grids[:, k]. img (B,H,W,C), grids (B,C,Ho,Wo,2) -> (B,Ho,Wo,C)."""
    if img.is_cuda:
        _require_float32(img, grids, "per-channel grid_sample")
        return _MultigridSampleCuda.apply(img.contiguous(), grids.float().contiguous())
    return grid_sample_multigrid_plain(img, grids)


def grid_sample_ctx_plain(img: torch.Tensor, grid: torch.Tensor, tp_sz: int) -> torch.Tensor:
    rep = img if tp_sz == 1 else img.repeat_interleave(tp_sz, dim=0)
    return grid_sample_plain(rep, grid)


def grid_sample_ctx(img: torch.Tensor, grid: torch.Tensor, *, tp_sz: int) -> torch.Tensor:
    """Shared-texture context-fusion sampling: grid row i samples img row
    i // tp_sz. img (F,H,W,C), grid (F*tp_sz,Ho,Wo,2) -> (F*tp_sz,Ho,Wo,C).
    On a CUDA tensor the kernel reads each texture once for its tp_sz grid
    rows; the plain version materializes tp_sz copies first."""
    f = img.shape[0]
    if grid.shape[0] != f * tp_sz:
        raise ValueError(f"grid rows {grid.shape[0]} != {f} textures * tp_sz {tp_sz}")
    if img.is_cuda:
        return _grid_sample_kernel(img, grid, tp_sz)
    return grid_sample_ctx_plain(img, grid, tp_sz)


def warp_alpha_ctx_plain(alpha_u, grids, occ, is_obj, *, tp_sz, tcp):
    """Plain PyTorch composition of the fused warp (same math as the kernel).
    Both pairwise products run as a loop over the occluder / layer axis, so
    memory stays at (N, gh, gw, C) instead of (N, gh, gw, C, C)."""
    f, h, w, c = alpha_u.shape
    n, _, gh, gw, _ = grids.shape
    a_g = alpha_u.float().repeat_interleave(tp_sz, dim=0)
    sam = grid_sample_multigrid_plain(a_g, grids)
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


def warp_alpha_ctx(alpha_u: torch.Tensor, grids: torch.Tensor, occ: torch.Tensor,
                   is_obj: Optional[torch.Tensor], *, tp_sz: int, tcp: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused predict-path alpha_ctx warp (sample + ghost mask + disocc max +
    prediction-time occlusion product + alpha-weighted flow reduction).

    alpha_u (F, H, W, C): unique frame-occluded per-layer alphas, F = B*Tc
    grids   (N, C, gh, gw, 2): per-layer grids, N = B*Tc*Tp row-major; row n
            samples frame n // tp_sz (ctx_ts uniform over the pred axis)
    occ     (N, C, C); is_obj (B*Tp, C, gh, gw) or None; tp_sz=Tp, tcp=Tc*Tp

    Returns (alpha_occ (N, gh, gw, C), disocc (N, gh, gw, 1),
    flow (N, gh, gw, 2) = sum_j alpha_occ_j * (g_j - base_grid)), float32."""
    f, h, w, c = alpha_u.shape
    n, gc = grids.shape[:2]
    if gc != c or n != f * tp_sz:
        raise ValueError(f"alpha {tuple(alpha_u.shape)} and grids {tuple(grids.shape)} "
                         f"disagree for tp_sz {tp_sz}")
    if alpha_u.is_cuda:
        io = is_obj.float().contiguous() if is_obj is not None else None
        return warp_alpha_ctx_cuda(alpha_u.float().contiguous(), grids.float().contiguous(),
                                   occ.float().contiguous(), io, tp_sz, tcp)
    return warp_alpha_ctx_plain(alpha_u, grids, occ, is_obj, tp_sz=tp_sz, tcp=tcp)
