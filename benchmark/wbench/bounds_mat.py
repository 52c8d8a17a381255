"""Roofline arithmetic of K3, the port's fused bias + activation
(``csrc/bias_act.cu``), on MAT's path.

A launch reads x and the bias once and writes its output once, float32:
4 (2 numel(x) + C) bytes at 3.35 TB/s; or it does the activation's float32
operations, ``OPS`` per element (the bias add, the activation, the gain,
the clamp's two where it clamps), at 67 TFLOP/s; its bound is the larger.
``k3_launch`` gives the arguments of ``KernelBounds``' ``add`` for one launch
that the plain ``bias_act`` (``plainref/ops/bias_act.py``) is told of, under
the program's counter name, ``bias_act``."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .bounds import KernelBounds

# float32 operations an element of each activation, with the bias add and
# the gain (csrc/bias_act.cu: act<A>); transcendental functions count one
OPS = {"linear": 2, "relu": 3, "lrelu": 4, "tanh": 3, "sigmoid": 5, "elu": 4, "selu": 6,
       "softplus": 7, "swish": 5}
NAME = "bias_act"


def k3_launch(x: torch.Tensor, b: Optional[torch.Tensor], act: str,
              clamp: Optional[float] = None) -> dict:
    n = x.numel()
    nbytes = 4 * (2 * n + (b.numel() if b is not None else 0))
    nops = n * (OPS[act] + (2 if clamp is not None and clamp >= 0 else 0))
    return {"name": NAME, "nbytes": nbytes, "nops": nops}


def k3_observer(bounds: KernelBounds) -> Callable:
    """An observer for the plain ``bias_act`` that adds each launch's bound
    to ``bounds`` (its ``add``), and nothing else."""
    return lambda **t: bounds("add", **k3_launch(**t))


def is_k3(name: str) -> bool:
    """K3's rows in a device trace (``bias_act_vec4_kernel``,
    ``bias_act_scalar_kernel``)."""
    return "bias_act_" in name and "_kernel" in name
