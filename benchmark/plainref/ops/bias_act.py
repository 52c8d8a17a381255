"""Fused bias + activation (+ gain + clamp), channel-last, in plain PyTorch:
the plain version of the program's K3 (``bias_act``), the only one here.

Where the program hands a CUDA tensor to K3, this copy tells an observer,
when one is installed (``observe``), of that launch: ``observer(x=..., b=...,
act=..., clamp=...)`` with the kernel's input. The benchmark counts the
kernel's bytes and operations from it. Without an observer nothing is told.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

_observers = []


@contextlib.contextmanager
def observe(observer: Callable):
    """Tell ``observer`` of every launch of K3 that the program would make
    inside the block."""
    _observers.append(observer)
    try:
        yield observer
    finally:
        _observers.remove(observer)


def _lrelu(x):
    return torch.where(x >= 0, x, x * 0.2)


def _elu(x):
    return torch.where(x >= 0, x, torch.expm1(x))


def _selu(x):
    return 1.0507009873554805 * torch.where(x >= 0, x, 1.6732632423543772 * torch.expm1(x))


def _softplus(x):
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0)


# name -> (function, default gain); the lrelu slope is 0.2
ACTS = {
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


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor] = None, act: str = "linear",
             gain: Optional[float] = None, clamp: Optional[float] = None) -> torch.Tensor:
    """y = clamp(act(x + b) * gain) over the last axis of x (..., C), b (C,)
    or None; ``gain`` defaults to the activation's own, ``clamp`` None or
    negative clamps nothing."""
    fn, default_gain = ACTS[act]
    gain = default_gain if gain is None else float(gain)
    if _observers and x.is_cuda and x.numel():
        for obs in _observers:
            obs(x=x, b=b, act=act, clamp=clamp)
    if b is not None:
        x = x + b.to(x.dtype)
    x = fn(x)
    if gain != 1.0:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x
