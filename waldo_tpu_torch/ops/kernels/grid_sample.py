"""Wrapper of the bilinear grid-sample kernel (csrc/grid_sample.cu), which
replaces ``grid_sample_pallas`` (waldo_tpu/ops/pallas/grid_sample.py) in both
of its modes: a grid shared by all channels with the ``tp_sz`` texture-row
mapping (context fusion), and one grid per channel (the training-path
alpha_ctx warp)."""
from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel
from .planes import MAX_CHANNELS, plane_boxes_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
GRID_SAMPLE = CudaKernel(
    "grid_sample.cu", "waldo_grid_sample",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])

_MAX_ROWS = 65535  # rows ride the launch grid's y dimension


def grid_sample_cuda(img: torch.Tensor, grid: torch.Tensor, tp_sz: int = 1) -> torch.Tensor:
    """img (F, H, W, C) float32 or bfloat16 on a CUDA device; grid float32,
    either shared (F*tp_sz, Ho, Wo, 2), row i reading texture i // tp_sz, or
    per-channel (F, C, Ho, Wo, 2) with tp_sz 1 and C <= 32. Returns (rows, Ho, Wo, C) in
    img's dtype: bilinear, zero padding, align_corners=False."""
    if not (img.is_cuda and grid.is_cuda and img.device == grid.device):
        raise ValueError(f"grid_sample_cuda needs both tensors on one CUDA device, "
                         f"got {img.device} and {grid.device}")
    if img.dtype not in (torch.float32, torch.bfloat16) or grid.dtype != torch.float32:
        raise TypeError(f"grid_sample_cuda takes a float32/bfloat16 texture and a "
                        f"float32 grid, got {img.dtype} and {grid.dtype}")
    if not (img.is_contiguous() and grid.is_contiguous()):
        raise ValueError("grid_sample_cuda needs contiguous tensors")
    if img.dim() != 4 or grid.shape[-1] != 2 or grid.dim() not in (4, 5):
        raise ValueError(f"bad shapes img {tuple(img.shape)} grid {tuple(grid.shape)}")
    f, h, w, c = img.shape
    per_channel = grid.dim() == 5
    rows, ho, wo = grid.shape[0], grid.shape[-3], grid.shape[-2]
    if per_channel and (tp_sz != 1 or grid.shape[1] != c or rows != f):
        raise ValueError(f"per-channel grids must be (F, C, Ho, Wo, 2) with tp_sz 1, "
                         f"got {tuple(grid.shape)} for img {tuple(img.shape)}, tp_sz {tp_sz}")
    if per_channel and c > MAX_CHANNELS:
        raise ValueError(f"per-channel grids take at most {MAX_CHANNELS} channels, got {c}")
    if not per_channel and rows != f * tp_sz:
        raise ValueError(f"grid rows {rows} != texture rows {f} * tp_sz {tp_sz}")
    if rows > _MAX_ROWS:
        raise ValueError(f"grid_sample_cuda takes at most {_MAX_ROWS} rows, got {rows}")
    if max(ho * wo, h * w) * c >= 2 ** 31:
        raise ValueError("grid_sample_cuda indexes one row's texture and output in 32 bits")
    out = torch.empty((rows, ho, wo, c), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    tex, boxes = img, None
    if per_channel:
        # one plane per channel, so that a warp's taps read neighbouring
        # texels of one plane, and the boxes that let the kernel skip samples
        tex, boxes = plane_boxes_cuda(img)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    GRID_SAMPLE.launch(rows, tex.data_ptr(), None if boxes is None else boxes.data_ptr(),
                       grid.data_ptr(), out.data_ptr(),
                       h, w, c, rows, ho, wo, tp_sz, int(per_channel),
                       int(img.dtype == torch.bfloat16), stream)
    return out
