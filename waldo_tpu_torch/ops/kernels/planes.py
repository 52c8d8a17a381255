"""Wrapper of the samplers' pre-pass kernel (csrc/planes.cu): a channel-last
texture to one plane per channel, with each plane's nonzero box (the card's
counterpart of ``_skip_flags`` in waldo_tpu/ops/pallas/grid_sample.py)."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
PLANE_BOXES = CudaKernel("planes.cu", "waldo_plane_boxes", [_P, _P, _P, _I, _I, _I, _I, _I, _P])

MAX_CHANNELS = 32  # a block stages 128 pixels x 32 channels in shared memory
_MAX_FRAMES = 65535  # frames ride the launch grid's z dimension


def plane_boxes_cuda(tex: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tex (F, H, W, C) float32 or bfloat16, contiguous, on a CUDA device,
    C <= 32. Returns (planes (F, C, H, W) in tex's dtype, boxes (F, C, 4)
    int32): each plane's inclusive nonzero box (y0, y1, x0, x1), (H, -1, W,
    -1) where the plane is all zero."""
    if not tex.is_cuda:
        raise ValueError(f"plane_boxes_cuda needs a CUDA tensor, got {tex.device}")
    if tex.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"plane_boxes_cuda takes float32 or bfloat16, got {tex.dtype}")
    if not tex.is_contiguous() or tex.dim() != 4:
        raise ValueError(f"plane_boxes_cuda needs a contiguous (F, H, W, C) tensor, "
                         f"got {tuple(tex.shape)}")
    f, h, w, c = tex.shape
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"plane_boxes_cuda takes 1 to {MAX_CHANNELS} channels, got {c}")
    if f > _MAX_FRAMES:
        raise ValueError(f"plane_boxes_cuda takes at most {_MAX_FRAMES} frames, got {f}")
    if h * w * c >= 2 ** 31:
        raise ValueError("plane_boxes_cuda indexes one frame in 32 bits")
    planes = torch.empty((f, c, h, w), dtype=tex.dtype, device=tex.device)
    boxes = torch.empty((f, c, 4), dtype=torch.int32, device=tex.device)
    if f == 0:
        return planes, boxes
    stream = torch.cuda.current_stream(tex.device).cuda_stream
    PLANE_BOXES.launch(f, tex.data_ptr(), planes.data_ptr(), boxes.data_ptr(), f, h, w, c,
                       int(tex.dtype == torch.bfloat16), stream)
    return planes, boxes
