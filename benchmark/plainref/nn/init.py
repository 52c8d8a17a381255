"""Weight initialization and compute dtypes (counterpart of
waldo_tpu/nn/init.py).

* Dense: truncated normal kernels (std 0.02, cut at two deviations, scaled
  like flax's ``truncated_normal`` so the cut distribution has std 0.02),
  zero biases;
* Conv and transposed conv: xavier-uniform kernels;
* norms: unit scale, zero bias; learned embeddings: the Dense kernel law.

Modules keep float32 parameters and compute their products in the dtype
given to their constructor (the JAX package's ``compute_dtype``). Every
module that owns parameters defines ``init_parameters(generator)``;
``init_module`` runs them all from one ``torch.Generator``.
"""
from __future__ import annotations

import torch

TRUNC_STD = 0.02
# std of a unit normal truncated to [-2, 2]
_TRUNC_UNIT_STD = 0.87962566103423978


def resolve_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, generator: torch.Generator, std: float = TRUNC_STD):
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.mul_(std / _TRUNC_UNIT_STD)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, generator: torch.Generator):
    torch.nn.init.xavier_uniform_(t, generator=generator)


@torch.no_grad()
def init_module(module: torch.nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        init = getattr(m, "init_parameters", None)
        if init is not None:
            init(generator)
