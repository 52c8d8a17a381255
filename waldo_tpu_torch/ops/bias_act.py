"""Fused bias + activation (+ gain + clamp) (counterpart of
waldo_tpu/ops/bias_act.py and its Pallas kernel bias_act_pallas).

``bias_act_plain`` is the plain PyTorch version, for any ``dim``. A CUDA
tensor goes to the hand-written kernel (ops/kernels/bias_act.py), which is
channel-last and float32 only, like the TPU kernel: a CUDA call with another
``dim`` or dtype raises instead of falling back to the plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .kernels import bias_act_cuda


def _lrelu(x):
    return torch.where(x >= 0, x, x * 0.2)


def _elu(x):
    return torch.where(x >= 0, x, torch.expm1(x))


def _selu(x):
    return 1.0507009873554805 * torch.where(x >= 0, x, 1.6732632423543772 * torch.expm1(x))


def _softplus(x):
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0)


# name -> (plain function, default gain); the lrelu slope is 0.2
_ACTS = {
    "linear": (lambda x: x, 1.0),
    "relu": (torch.relu, math.sqrt(2.0)),
    "lrelu": (_lrelu, math.sqrt(2.0)),
    "tanh": (torch.tanh, 1.0),
    "sigmoid": (torch.sigmoid, 1.0),
    "elu": (_elu, 1.0),
    "selu": (_selu, 1.0),
    "softplus": (_softplus, 1.0),
    "swish": (F.silu, math.sqrt(2.0)),
}


def bias_act_plain(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = -1,
                   act: str = "linear", gain: float = 1.0,
                   clamp: Optional[float] = None) -> torch.Tensor:
    """y = clamp(act(x + b) * gain); b (C,) broadcasts along ``dim``."""
    fn = _ACTS[act][0]
    if b is not None:
        shape = [1] * x.dim()
        shape[dim] = b.shape[0]
        x = x + b.reshape(shape).to(x.dtype)
    x = fn(x)
    if gain != 1.0:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, dim: int = -1,
             act: str = "linear", gain: Optional[float] = None,
             clamp: Optional[float] = None) -> torch.Tensor:
    """y = clamp(act(x + b) * gain), gain defaulting to the activation's
    own (sqrt 2 for relu, lrelu and swish). The lrelu slope is fixed at 0.2,
    as in the JAX function, so there is no slope argument."""
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")
    gain = _ACTS[act][1] if gain is None else float(gain)
    if x.is_cuda:
        if dim not in (-1, x.dim() - 1):
            raise ValueError(f"the bias_act kernel is channel-last only, got dim {dim} "
                             f"for a {x.dim()}-d tensor")
        return bias_act_cuda(x.contiguous(), b, act, gain, clamp)
    return bias_act_plain(x, b, dim, act, gain, clamp)
