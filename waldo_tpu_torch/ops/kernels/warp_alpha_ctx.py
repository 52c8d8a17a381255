"""Wrapper of the fused alpha_ctx warp kernel (csrc/warp_alpha_ctx.cu), which
replaces ``warp_alpha_ctx_pallas`` (waldo_tpu/ops/pallas/grid_sample.py)."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .build import CudaKernel
from .planes import plane_boxes_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
WARP_ALPHA_CTX = CudaKernel(
    "warp_alpha_ctx.cu", "waldo_warp_alpha_ctx",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])

MAX_LAYERS = 32  # the kernel keeps a pixel's layers in registers, at most 32


def warp_alpha_ctx_cuda(alpha: torch.Tensor, grid: torch.Tensor, occ: torch.Tensor,
                        is_obj: Optional[torch.Tensor], tp_sz: int, tcp: int
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """alpha (F, H, W, C), grid (N, C, gh, gw, 2) with N = F*tp_sz, occ
    (N, C, C), is_obj (B*Tp, C, gh, gw) or None; all float32, contiguous, on
    one CUDA device. Returns float32 (alpha_occ (N, gh, gw, C),
    disocc (N, gh, gw, 1), flow (N, gh, gw, 2))."""
    ts = [alpha, grid, occ] + ([is_obj] if is_obj is not None else [])
    if not all(t.is_cuda and t.device == alpha.device for t in ts):
        raise ValueError("warp_alpha_ctx_cuda needs every tensor on one CUDA device")
    if not all(t.dtype == torch.float32 for t in ts):
        raise TypeError(f"warp_alpha_ctx_cuda takes float32, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("warp_alpha_ctx_cuda needs contiguous tensors")
    f, h, w, c = alpha.shape
    n, gc, gh, gw, two = grid.shape
    if gc != c or two != 2 or n != f * tp_sz or tuple(occ.shape) != (n, c, c):
        raise ValueError(f"bad shapes alpha {tuple(alpha.shape)} grid {tuple(grid.shape)} "
                         f"occ {tuple(occ.shape)} tp_sz {tp_sz}")
    if tcp % tp_sz != 0:
        raise ValueError(f"tcp {tcp} must be a multiple of tp_sz {tp_sz}")
    if is_obj is not None and (is_obj.shape[1:] != (c, gh, gw)
                               or is_obj.shape[0] < (n - 1) // tcp * tp_sz + tp_sz):
        raise ValueError(f"bad is_obj shape {tuple(is_obj.shape)}")
    if c > MAX_LAYERS:
        raise ValueError(f"warp_alpha_ctx_cuda takes at most {MAX_LAYERS} layers, got {c}")
    if max(gh * gw, h * w) * c >= 2 ** 31 or n * -(-gh * gw // 128) >= 2 ** 31:
        raise ValueError("warp_alpha_ctx_cuda indexes one row's planes and output, and its "
                         "tiles, in 32 bits")
    dev = alpha.device
    alpha_occ = torch.empty((n, gh, gw, c), dtype=torch.float32, device=dev)
    disocc = torch.empty((n, gh, gw, 1), dtype=torch.float32, device=dev)
    flow = torch.empty((n, gh, gw, 2), dtype=torch.float32, device=dev)
    if alpha_occ.numel() == 0:
        return alpha_occ, disocc, flow
    # one plane per layer, so that a warp's taps of one layer read
    # neighbouring texels, and the boxes that let the kernel skip samples
    planes, boxes = plane_boxes_cuda(alpha)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # launches keyed by (row count, whether the ghost mask rides along)
    WARP_ALPHA_CTX.launch(
        (n, is_obj is not None), planes.data_ptr(), boxes.data_ptr(), grid.data_ptr(),
        occ.data_ptr(), is_obj.data_ptr() if is_obj is not None else None,
        alpha_occ.data_ptr(), disocc.data_ptr(), flow.data_ptr(),
        h, w, c, n, gh, gw, tp_sz, tcp, stream)
    return alpha_occ, disocc, flow
