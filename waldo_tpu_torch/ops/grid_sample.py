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
without reading a texel (the TPU kernels' sparsity skip); ``bwd_tap_routes``
models where the per-channel backward kernel sums each tap term of grad_img,
``shared_bwd_windows`` the texture windows the shared-grid backward kernel
stages for its tiles of output pixels, and ``shared_fwd_windows`` and
``fwd_block`` the shared-grid forward kernel's windows and block order.
The kernels and the plain versions compute in float32: the JAX signatures'
``precision`` has no counterpart here, since "fast" sampling only decides
where the callers store bf16 maps.
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
        # no copy on the training step: the Warper's bf16 cast of the sampled
        # frames hands grad back as a fresh contiguous float32 tensor
        g_img, g_grid = grid_sample_bwd_cuda(img, grid, grad.float().contiguous(), ctx.tp_sz,
                                             ctx.needs_input_grad[0])
        return g_img, g_grid if ctx.needs_input_grad[1] else None, None


def _wants_grad(img: torch.Tensor, grid: torch.Tensor) -> bool:
    """Whether autograd has to record a sample of img along grid."""
    return torch.is_grad_enabled() and (img.requires_grad or grid.requires_grad)


def _grid_sample_kernel(img, grid, tp_sz):
    if _wants_grad(img, grid):
        _require_float32(img, grid, "grid_sample")
        return _GridSampleCuda.apply(img.contiguous(), grid.float().contiguous(), tp_sz)
    # nothing asks for a gradient (predict, the evaluator, the MAT warps,
    # WIF's decode): the kernel's wrapper alone, without the autograd
    # function's host work, which took longer than the MAT warps' kernel
    return grid_sample_cuda(img.contiguous(), grid.float().contiguous(), tp_sz)


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


def _top_left(g: torch.Tensor, size: int) -> torch.Tensor:
    """The kernels' top-left tap index along one axis of a normalized grid
    coordinate, rounded step by step as csrc/bilinear.cuh's top_left_tap."""
    i = (g.float() + 1.0) * (size * 0.5) - 0.5
    return torch.floor(i.clamp(-2.0, size + 1.0)).long()


def tap_footprint_skips(grids: torch.Tensor, boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The kernels' sparsity test, in plain PyTorch: grids (R, C, gh, gw, 2)
    sampling planes of size h x w whose nonzero boxes are boxes (R, C, 4).
    True where the 2x2 bilinear footprint of a (row, layer, pixel) sample
    misses its plane's box, so that the sample is exactly 0 and the kernels
    read no texel for it (csrc/bilinear.cuh: top_left_tap, misses_box)."""
    x0, y0 = _top_left(grids[..., 0], w), _top_left(grids[..., 1], h)
    b = boxes[:, :, None, None, :]
    return (x0 + 1 < b[..., 2]) | (x0 > b[..., 3]) | (y0 + 1 < b[..., 0]) | (y0 > b[..., 1])


# the largest plane (texels) whose grad_img the per-channel backward kernel
# sums in shared memory (csrc/grid_sample_bwd.cu: kPlaneCap)
BWD_PLANE_CAP = 56 * 1024


def bwd_tap_routes(grids: torch.Tensor, grad_out: torch.Tensor, h: int, w: int,
                   cap: int = BWD_PLANE_CAP) -> torch.Tensor:
    """The per-channel backward kernel's split of grad_img, in plain PyTorch:
    grids (R, C, Ho, Wo, 2) sampling planes of size h x w, grad_out (R, Ho,
    Wo, C). The kernel gives each plane a block; the window, which it sums
    in shared memory and stores once, is the whole plane where it holds at
    most ``cap`` texels, else there is none and every term goes to grad_img
    by a device atomic. Returns (R, C, Ho, Wo, 4) int8 per tap, in tap order
    (y0,x0) (y0,x1) (y1,x0) (y1,x1): 0 the tap adds nothing (off the plane,
    or the output gradient is 0), 1 it adds into the window, 2 it adds
    straight into grad_img (csrc/grid_sample_bwd.cu, per-channel mode)."""
    x0, y0 = _top_left(grids[..., 0], w), _top_left(grids[..., 1], h)
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1], dim=-1)
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1], dim=-1)
    live = ((grad_out.permute(0, 3, 1, 2) != 0)[..., None]
            & (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h))
    return (live.to(torch.int8) * (1 if h * w <= cap else 2)).to(torch.int8)


def _tile_boxes(grid: torch.Tensor, h: int, w: int, th: int, tw: int) -> torch.Tensor:
    """The inclusive box (x_lo, x_hi, y_lo, y_hi) of the texels that the
    valid bilinear taps of each th x tw tile of output pixels read, for grid
    (R, Ho, Wo, 2) on textures of h x w texels: (R, ceil(Ho / th),
    ceil(Wo / tw), 4) int64, (w, -1, h, -1) where no tap of the tile lies on
    the texture."""
    r, ho, wo = grid.shape[:3]
    x0, y0 = _top_left(grid[..., 0], w), _top_left(grid[..., 1], h)
    on_x = ((x0 >= 0) & (x0 < w)) | ((x0 + 1 >= 0) & (x0 + 1 < w))
    on_y = ((y0 >= 0) & (y0 < h)) | ((y0 + 1 >= 0) & (y0 + 1 < h))
    ok = on_x & on_y  # some tap of the pixel lies on the texture
    big = 1 << 40
    lo_hi = torch.stack([torch.where(ok, x0.clamp(min=0), big),
                         torch.where(ok, -(x0 + 1).clamp(max=w - 1), big),
                         torch.where(ok, y0.clamp(min=0), big),
                         torch.where(ok, -(y0 + 1).clamp(max=h - 1), big)], dim=-1)
    ny, nx = -(-ho // th), -(-wo // tw)
    lo_hi = torch.nn.functional.pad(lo_hi, (0, 0, 0, nx * tw - wo, 0, ny * th - ho), value=big)
    box = lo_hi.reshape(r, ny, th, nx, tw, 4).amin(dim=(2, 4))
    empty = box[..., 0] == big
    box = torch.where(empty[..., None], torch.tensor([w, 1, h, 1], device=grid.device), box)
    return box * torch.tensor([1, -1, 1, -1], device=grid.device)


# the shared-grid backward kernel (csrc/grid_sample_bwd.cu, shared mode): a
# block takes a BWD_TILE x BWD_TILE tile of output pixels and stages, for
# BWD_MAX_C channels at a time, the texture window its taps reach where the
# window holds at most BWD_WINDOW_CAP floats
BWD_TILE = 16
BWD_MAX_C = 32
BWD_WINDOW_CAP = 12 * 1024


def shared_bwd_windows(grid: torch.Tensor, h: int, w: int, c: int) -> torch.Tensor:
    """The shared-grid backward kernel's texture windows, in plain PyTorch:
    grid (R, Ho, Wo, 2) sampling textures of h x w texels and c channels.
    Returns (R, ceil(Ho / BWD_TILE), ceil(Wo / BWD_TILE), 6) int64, for each
    tile: the inclusive box (x_lo, x_hi, y_lo, y_hi) of the texels its
    valid taps read ((w, -1, h, -1) where none does), the window's row
    stride in floats for its first min(c, BWD_MAX_C) channels (its width
    times that, rounded up to 16 mod 32), and 1 where the window, rows of
    that stride, fits BWD_WINDOW_CAP floats and is staged in shared memory,
    else 0 (the tile reads its texels from device memory)."""
    box = _tile_boxes(grid, h, w, BWD_TILE, BWD_TILE)
    cw = min(c, BWD_MAX_C)
    row = (box[..., 1] - box[..., 0] + 1).clamp(min=0) * cw
    stride = row + (16 - row) % 32
    rows = (box[..., 3] - box[..., 2] + 1).clamp(min=0)
    return torch.cat([box, stride[..., None], (rows * stride <= BWD_WINDOW_CAP).long()[..., None]],
                     dim=-1)


# K2's shared-grid forward (csrc/grid_sample.cu, shared mode): for more than
# FWD_FEW_C channels a block takes a FWD_TILE_H x FWD_TILE_W tile of output
# pixels of one grid row, a warp two of its rows; runs of consecutive warps
# (bands) stage the texture window their taps reach, each at most
# fwd_window_cap elements. With at most FWD_FEW_C channels a thread takes a
# pixel and reads its taps from the texture.
FWD_TILE_W, FWD_TILE_H = 16, 8
FWD_WARPS = FWD_TILE_W * FWD_TILE_H // 32
FWD_WIN_BYTES = 19 * 1024
FWD_FEW_C = 4


def fwd_window_cap(itemsize: int) -> int:
    """The most texture elements a forward block stages (csrc/grid_sample.cu:
    kWinBytes)."""
    return FWD_WIN_BYTES // itemsize


def fwd_block(b: int, tp_sz: int, tiles_y: int, tiles_x: int) -> Tuple[int, int, int]:
    """The forward tile kernel's order of its blocks: block b takes (grid
    row, tile row, tile column), tile-major with the tp_sz grid rows of one
    texture's tile side by side."""
    j, b = b % tp_sz, b // tp_sz
    tx, b = b % tiles_x, b // tiles_x
    return (b // tiles_y) * tp_sz + j, b % tiles_y, tx


def shared_fwd_windows(grid: torch.Tensor, h: int, w: int, c: int,
                       itemsize: int = 4) -> torch.Tensor:
    """The forward tile kernel's texture windows (c > FWD_FEW_C), in plain
    PyTorch: grid (R, Ho, Wo, 2) sampling textures of h x w texels, c
    channels of itemsize bytes. Each warp's box is the box of the texels
    its pixels' valid taps read (``_tile_boxes`` of 2 x FWD_TILE_W pixels);
    the warps that hold a tile's rows, in order, join a band while the
    union of their boxes, staged as rows of the stride below, fits
    ``fwd_window_cap``. The stride of a window w texels wide is w*c + v - 1
    elements (v = 16 // itemsize where a texture row is a whole number of
    16-byte vectors, whose copies start aligned, else 1) rounded up to 16
    mod 32. Returns (R, ceil(Ho / FWD_TILE_H), ceil(Wo / FWD_TILE_W),
    FWD_WARPS, 7) int64, for each warp: its band's box (x_lo, x_hi, y_lo,
    y_hi), (w, -1, h, -1) where empty; its band's first warp (-1 for a warp
    with no output pixel); the window's row stride; and 1 where the window
    is staged, else 0 (a band of one warp over the cap: its pixels read
    their texels from device memory)."""
    r, ho = grid.shape[:2]
    vec = 16 // itemsize if (w * c * itemsize) % 16 == 0 else 1
    cap = fwd_window_cap(itemsize)
    ny = -(-ho // FWD_TILE_H)
    warp_boxes = _tile_boxes(grid, h, w, 2, FWD_TILE_W)
    boxes = torch.tensor([w, -1, h, -1], device=grid.device).repeat(
        r, ny * FWD_WARPS, warp_boxes.shape[2], 1)  # warps past the last row: empty
    boxes[:, :warp_boxes.shape[1]] = warp_boxes
    boxes = boxes.reshape(r, ny, FWD_WARPS, -1, 4).transpose(2, 3)  # (R, ny, nx, warps, 4)
    rows_left = ho - FWD_TILE_H * torch.arange(ny, device=grid.device)  # rows of each tile row
    live = 2 * torch.arange(FWD_WARPS, device=grid.device) < rows_left[:, None]
    live = live[None, :, None, :].expand(boxes.shape[:4])

    def stride(b):
        n = (b[..., 1] - b[..., 0] + 1).clamp(min=0) * c + vec - 1
        return n + (16 - n) % 32

    def elems(b):
        return torch.where(b[..., 0] > b[..., 1], 0, (b[..., 3] - b[..., 2] + 1) * stride(b))

    def union(a, b):
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        return torch.stack([lo[..., 0], hi[..., 1], lo[..., 2], hi[..., 3]], dim=-1)

    win, start = [boxes[..., 0, :]], [torch.zeros_like(boxes[..., 0, 0])]
    for k in range(1, FWD_WARPS):
        u = union(win[-1], boxes[..., k, :])
        join = (elems(u) <= cap) | ~live[..., k]
        win.append(torch.where(join[..., None], u, boxes[..., k, :]))
        start.append(torch.where(join, start[-1], k))
    for k in range(FWD_WARPS - 2, -1, -1):  # a band's window is its last warp's union
        same = start[k + 1] == start[k]
        win[k] = torch.where(same[..., None], win[k + 1], win[k])
    win, start = torch.stack(win, dim=-2), torch.stack(start, dim=-1)
    start = torch.where(live, start, -1)
    empty = win[..., 0] > win[..., 1]
    win = torch.where(empty[..., None], torch.tensor([w, -1, h, -1], device=grid.device), win)
    st = torch.where(empty, 0, stride(win))
    return torch.cat([win, start[..., None], st[..., None], (elems(win) <= cap).long()[..., None]],
                     dim=-1)


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
        # grad keeps its layout: the kernel reads it as planes, as the
        # training path hands it over
        g_img, g_grids = grid_sample_per_channel_bwd_cuda(
            planes, boxes, grids, grad.float(), ctx.needs_input_grad[0])
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
