"""The nets' weights, made from a run's seed on the device.

The laws are the ones the nets are built for, read from the reference's
modules (the plain copy under ``plainref``), never from the program's
initialiser: dense kernels N(0, 0.02) cut at two deviations, convolution
kernels N(0, 2 / (fan_in + fan_out)) (xavier's variance), learned
embeddings as dense kernels, norm scales 1, biases and noise strengths 0,
and 0 for every kernel that the configuration zeroes at initialisation
(``pe_estimator_init_mode zero``, ``ii_ab``'s last convolution, FLP's
``zero_init_dec`` heads, ...) where the weights stand for an initialised
net (``initialized``, a training script's start). Weights that stand for a
trained net (``trained``, what test.sh loads from its checkpoints) draw
those kernels from their module's law too, so that every net reaches the
outputs. One normal draw over all parameters, then one scale and one offset
per element, in float32, the type the nets are served in.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

DENSE_STD = 0.02


KINDS = ("initialized", "trained")


def _law(net: torch.nn.Module, name: str, shape: Tuple[int, ...],
         kind: str) -> Tuple[float, float]:
    """(std, offset) of one parameter of ``net``."""
    mod_name, _, leaf = name.rpartition(".")
    owner = net.get_submodule(mod_name) if mod_name else net
    mkind = type(owner).__name__
    if leaf == "bias" or leaf == "noise_strength":
        return 0.0, 0.0
    if mkind == "CustomNorm":
        return 0.0, 1.0
    if kind == "initialized" and getattr(owner, "zero_init", False) and leaf == "weight":
        return 0.0, 0.0
    if mkind == "_Conv":
        rf = 1
        for s in shape[2:]:
            rf *= s
        return (2.0 / ((shape[0] + shape[1]) * rf)) ** 0.5, 0.0
    if len(shape) >= 2:  # dense kernels and learned embeddings
        return DENSE_STD, 0.0
    raise ValueError(f"no law for the parameter {name} {shape} of a {mkind}")


def layout(nets: Dict[str, torch.nn.Module], kind: str
           ) -> List[Tuple[str, str, Tuple[int, ...], float, float]]:
    """(net, name, shape, std, offset) of every parameter, in a fixed order."""
    if kind not in KINDS:
        raise ValueError(f"weights are {' or '.join(KINDS)}, not {kind!r}")
    out = []
    for key in sorted(nets):
        net = nets[key]
        for name, p in net.named_parameters():
            shape = tuple(p.shape)
            out.append((key, name, shape) + _law(net, name, shape, kind))
    return out


def make(nets: Dict[str, torch.nn.Module], seed: int, device,
         kind: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: {name: tensor}} for the nets' parameters (their modules may sit
    on the meta device), drawn from ``seed`` on ``device``, ``initialized``
    or ``trained``."""
    lay = layout(nets, kind)
    sizes = [int(torch.Size(s).numel()) for _, _, s, _, _ in lay]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    counts = torch.tensor(sizes, device=device)
    std = torch.repeat_interleave(torch.tensor([l[3] for l in lay], device=device), counts)
    off = torch.repeat_interleave(torch.tensor([l[4] for l in lay], device=device), counts)
    flat = flat.mul_(std).add_(off)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for (key, name, shape, _, _), part in zip(lay, flat.split(sizes)):
        out.setdefault(key, {})[name] = part.view(shape)
    return out


@torch.no_grad()
def load_into(nets: Dict[str, torch.nn.Module], weights: Dict[str, Dict[str, torch.Tensor]]) -> None:
    """Copy the made weights into the program's nets, every parameter."""
    for key, net in nets.items():
        given = weights[key]
        names = {n for n, _ in net.named_parameters()}
        if names != set(given):
            raise KeyError(f"{key}: the program's parameters and the made ones differ: "
                           f"{sorted(names ^ set(given))[:6]}")
        for name, p in net.named_parameters():
            p.copy_(given[name])
