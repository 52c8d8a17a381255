"""Wrappers of the bilinear grid-sample kernels (csrc/grid_sample.cu and its
backward, csrc/grid_sample_bwd.cu), which replace ``grid_sample_pallas``
(waldo_tpu/ops/pallas/grid_sample.py) and the VJPs the JAX package attaches
to it, in both of its modes: a grid shared by all channels, with the
``tp_sz`` texture-row mapping (context fusion; ``tp_sz`` 1 is the batch
mode of the training path), and one grid per channel (the training-path
alpha_ctx warp). Each mode and direction counts its launches apart."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import CudaKernel
from .planes import MAX_CHANNELS, plane_boxes_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]
_BWD_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]
# K2 (shared grid) and K2' (per-channel grids) share one source and entry point
GRID_SAMPLE = CudaKernel("grid_sample.cu", "waldo_grid_sample", _FWD_ARGS)
GRID_SAMPLE_PER_CHANNEL = CudaKernel("grid_sample.cu", "waldo_grid_sample", _FWD_ARGS)
GRID_SAMPLE_BWD = CudaKernel("grid_sample_bwd.cu", "waldo_grid_sample_bwd", _BWD_ARGS)
GRID_SAMPLE_PER_CHANNEL_BWD = CudaKernel("grid_sample_bwd.cu", "waldo_grid_sample_bwd",
                                         _BWD_ARGS)

_MAX_ROWS = 65535  # rows ride the launch grid's y dimension


def _check(img: torch.Tensor, grid: torch.Tensor, tp_sz: int, dtypes, shape=None) -> None:
    """Device, type, contiguity and shape checks of a sample's texture and
    grid; ``shape`` is the texture's (F, H, W, C) where img holds it in
    another layout (the planes)."""
    # a call's host time counts (the MAT warps' kernel runs for a few
    # microseconds): each property is read once
    if not (img.is_cuda and grid.is_cuda and img.get_device() == grid.get_device()):
        raise ValueError(f"grid_sample_cuda needs both tensors on one CUDA device, "
                         f"got {img.device} and {grid.device}")
    if img.dtype not in dtypes or grid.dtype != torch.float32:
        raise TypeError(f"grid_sample_cuda takes a {'/'.join(str(d) for d in dtypes)} texture "
                        f"and a float32 grid, got {img.dtype} and {grid.dtype}")
    if not (img.is_contiguous() and grid.is_contiguous()):
        raise ValueError("grid_sample_cuda needs contiguous tensors")
    shape = img.shape if shape is None else tuple(shape)
    gshape = grid.shape
    if len(shape) != 4 or gshape[-1] != 2 or len(gshape) not in (4, 5):
        raise ValueError(f"bad shapes img {tuple(shape)} grid {tuple(gshape)}")
    f, h, w, c = shape
    rows, ho, wo = gshape[0], gshape[-3], gshape[-2]
    if len(gshape) == 5:
        if tp_sz != 1 or gshape[1] != c or rows != f:
            raise ValueError(f"per-channel grids must be (F, C, Ho, Wo, 2) with tp_sz 1, got "
                             f"{tuple(grid.shape)} for img {tuple(img.shape)}, tp_sz {tp_sz}")
        if c > MAX_CHANNELS:
            raise ValueError(f"per-channel grids take at most {MAX_CHANNELS} channels, got {c}")
    elif rows != f * tp_sz:
        raise ValueError(f"grid rows {rows} != texture rows {f} * tp_sz {tp_sz}")
    if rows > _MAX_ROWS:
        raise ValueError(f"grid_sample_cuda takes at most {_MAX_ROWS} rows, got {rows}")
    if max(ho * wo, h * w) * c >= 2 ** 31:
        raise ValueError("grid_sample_cuda indexes one row's texture and output in 32 bits")


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream on t's device (a short call:
    the MAT warps' kernel takes less time than a wrapper's host work)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def grid_sample_cuda(img: torch.Tensor, grid: torch.Tensor, tp_sz: int = 1) -> torch.Tensor:
    """Shared grid (K2): img (F, H, W, C) float32 or bfloat16 on a CUDA
    device, grid (F*tp_sz, Ho, Wo, 2) float32, row i reading texture
    i // tp_sz. Returns (rows, Ho, Wo, C) in img's dtype: bilinear, zero
    padding, align_corners=False."""
    if grid.dim() != 4:
        raise ValueError(f"a shared grid is (rows, Ho, Wo, 2), got {tuple(grid.shape)}")
    _check(img, grid, tp_sz, (torch.float32, torch.bfloat16))
    f, h, w, c = img.shape
    rows, ho, wo, _ = grid.shape
    out = img.new_empty((rows, ho, wo, c))
    if out.numel() == 0:
        return out
    GRID_SAMPLE.launch(rows, img.data_ptr(), None, grid.data_ptr(), out.data_ptr(),
                       h, w, c, rows, ho, wo, tp_sz, 0, int(img.dtype == torch.bfloat16),
                       _stream(img))
    return out


def grid_sample_per_channel_cuda(img: torch.Tensor, grids: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-channel grids (K2'): img (F, H, W, C), grids (F, C, Ho, Wo, 2).
    Returns (out (F, Ho, Wo, C) in img's dtype, and the pre-pass's planes
    (F, C, H, W) and nonzero boxes (F, C, 4), which the backward reads)."""
    if grids.dim() != 5:
        raise ValueError(f"per-channel grids are (F, C, Ho, Wo, 2), got {tuple(grids.shape)}")
    _check(img, grids, 1, (torch.float32, torch.bfloat16))
    f, h, w, c = img.shape
    ho, wo = grids.shape[2:4]
    out = torch.empty((f, ho, wo, c), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        boxes = torch.empty((f, c, 4), dtype=torch.int32, device=img.device)
        return out, img.new_empty((f, c, h, w)), boxes
    # one plane per channel, so that a warp's taps read neighbouring texels
    # of one plane, and the boxes that let the kernel skip samples
    planes, boxes = plane_boxes_cuda(img)
    GRID_SAMPLE_PER_CHANNEL.launch(f, planes.data_ptr(), boxes.data_ptr(), grids.data_ptr(),
                                   out.data_ptr(), h, w, c, f, ho, wo, 1, 1,
                                   int(img.dtype == torch.bfloat16), _stream(img))
    return out, planes, boxes


def grid_sample_bwd_cuda(img: torch.Tensor, grid: torch.Tensor, grad_out: torch.Tensor,
                         tp_sz: int, need_img: bool
                         ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Backward of ``grid_sample_cuda`` with a shared grid, float32 only:
    img (F, H, W, C), grid (F*tp_sz, Ho, Wo, 2), grad_out (F*tp_sz, Ho, Wo,
    C), all contiguous (the training step hands grad_out over so: the
    Warper's bf16 cast of the sampled frames gives it back as a fresh
    float32 tensor). Returns (grad_img (F, H, W, C) or None unless need_img,
    grad_grid)."""
    _check(img, grid, tp_sz, (torch.float32,))
    if grid.dim() != 4 or grad_out.shape != grid.shape[:3] + img.shape[3:]:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} does not fit grid "
                         f"{tuple(grid.shape)} and img {tuple(img.shape)}")
    if grad_out.dtype != torch.float32 or not grad_out.is_contiguous():
        raise TypeError("grid_sample_bwd_cuda takes a contiguous float32 grad_out")
    f, h, w, c = img.shape
    rows, ho, wo = grid.shape[:3]
    g_grid = torch.empty_like(grid)
    g_img = torch.zeros_like(img) if need_img else None
    if g_grid.numel() == 0:
        return g_img, g_grid
    GRID_SAMPLE_BWD.launch(rows, img.data_ptr(), None, grid.data_ptr(), grad_out.data_ptr(),
                           g_grid.data_ptr(), None if g_img is None else g_img.data_ptr(),
                           h, w, c, rows, ho, wo, tp_sz, 0, _stream(img))
    return g_img, g_grid


def per_channel_bwd_launch(planes: torch.Tensor, boxes: torch.Tensor, grids: torch.Tensor,
                           grad_planes: torch.Tensor, g_grid: torch.Tensor,
                           g_img_planes: Optional[torch.Tensor]) -> None:
    """Launch the K2' backward into given outputs: grad_planes is the output
    gradient as contiguous (F, C, Ho, Wo) planes, g_grid like grids,
    g_img_planes (F, C, H, W) (any contents: the kernel writes every texel)
    or None for no texture gradient."""
    f, c, h, w = planes.shape
    ho, wo = grids.shape[2:4]
    GRID_SAMPLE_PER_CHANNEL_BWD.launch(
        f, planes.data_ptr(), boxes.data_ptr(), grids.data_ptr(), grad_planes.data_ptr(),
        g_grid.data_ptr(), None if g_img_planes is None else g_img_planes.data_ptr(),
        h, w, c, f, ho, wo, 1, 1, _stream(planes))


def grid_sample_per_channel_bwd_cuda(planes: torch.Tensor, boxes: torch.Tensor,
                                     grids: torch.Tensor, grad_out: torch.Tensor,
                                     need_img: bool
                                     ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Backward of the per-channel sample (K2'), float32 only, from the
    forward's planes (F, C, H, W) and boxes (F, C, 4): grids (F, C, Ho, Wo,
    2), grad_out (F, Ho, Wo, C). Returns (grad_img (F, H, W, C) or None
    unless need_img, grad_grids). The kernel works on planes: grad_out is
    read as (F, C, Ho, Wo) planes, without a copy where its memory is laid
    out so (the training path's is: its caller holds the sampled alphas as
    planes), and grad_img is written as planes and returned as their (F, H,
    W, C) view, which that caller turns back into planes without a copy."""
    if planes.dim() != 4 or boxes.shape != planes.shape[:2] + (4,):
        raise ValueError(f"planes must be (F, C, H, W) with boxes (F, C, 4), got "
                         f"{tuple(planes.shape)} and {tuple(boxes.shape)}")
    if boxes.dtype != torch.int32 or not boxes.is_contiguous():
        raise TypeError("the boxes must be contiguous int32")
    f, c, h, w = planes.shape
    if boxes.device != planes.device:
        raise ValueError("the planes and their boxes must lie on one device")
    _check(planes, grids, 1, (torch.float32,), shape=(f, h, w, c))
    ho, wo = grids.shape[2:4]
    if grad_out.shape != (f, ho, wo, c):
        raise ValueError(f"grad_out {tuple(grad_out.shape)} does not fit grids "
                         f"{tuple(grids.shape)}")
    if grad_out.dtype != torch.float32 or grad_out.device != planes.device:
        raise TypeError("grid_sample_per_channel_bwd_cuda takes a float32 grad_out on the "
                        "planes' device")
    grad_planes = grad_out.permute(0, 3, 1, 2).contiguous()  # a view where it is laid out so
    g_grid = torch.empty_like(grids)
    g_planes = None
    if need_img:  # where the kernel runs it writes every texel
        g_planes = torch.empty_like(planes) if g_grid.numel() > 0 else torch.zeros_like(planes)
    if g_grid.numel() > 0:
        per_channel_bwd_launch(planes, boxes, grids, grad_planes, g_grid, g_planes)
    return None if g_planes is None else g_planes.permute(0, 2, 3, 1), g_grid
