"""Wrapper of the fused bias + activation kernel (csrc/bias_act.cu), which
replaces ``bias_act_pallas`` (waldo_tpu/ops/pallas/bias_act.py). Its launch
count is keyed by activation."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
BIAS_ACT = CudaKernel(
    "bias_act.cu", "waldo_bias_act",
    [_P, _P, _P, ctypes.c_int64, _I, _I, ctypes.c_float, ctypes.c_float, _P])

# the kernel's activation ids (csrc/bias_act.cu, enum Act)
ACT_IDS = {"linear": 0, "relu": 1, "lrelu": 2, "tanh": 3, "sigmoid": 4, "elu": 5,
           "selu": 6, "softplus": 7, "swish": 8}


def bias_act_cuda(x: torch.Tensor, b: Optional[torch.Tensor], act: str, gain: float,
                  clamp: Optional[float]) -> torch.Tensor:
    """y = clamp(act(x + b) * gain) over the last axis of x (..., C); x and b
    (C,) or None float32, contiguous, on one CUDA device. ``clamp`` None or
    negative means no clamp. Returns a new float32 tensor."""
    ts = [x] + ([b] if b is not None else [])
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("bias_act_cuda needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if not all(t.dtype == torch.float32 for t in ts):
        raise TypeError(f"bias_act_cuda takes float32, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("bias_act_cuda needs contiguous tensors")
    if act not in ACT_IDS:
        raise ValueError(f"unknown activation {act!r}")
    if x.dim() == 0:
        raise ValueError("bias_act_cuda needs a channel axis")
    c = x.shape[-1]
    if b is not None and tuple(b.shape) != (c,):
        raise ValueError(f"bias of shape {tuple(b.shape)} does not fit {c} channels")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    clamp = -1.0 if clamp is None or clamp < 0 else float(clamp)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    BIAS_ACT.launch(act, x.data_ptr(), b.data_ptr() if b is not None else None,
                    y.data_ptr(), x.numel(), c, ACT_IDS[act], float(gain), clamp, stream)
    return y
