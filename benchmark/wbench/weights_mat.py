"""MAT's state (parameters and buffers), made from a seed on the device, as
``weights.py`` makes the other nets' weights: one normal draw over every
element, cut at two deviations, then one scale and one offset per element,
float32. The laws are those of the plain reference's modules
(``plainref/models/mat.py``, the published MAT's initialisation): MAT's
layers apply their gains at run time (equalized learning rate), so a stored
kernel is unit normal, and a dense kernel of learning-rate multiplier ``lr``
is N(0, 1) / lr (the mapping's, at 0.01, N(0, 100)); ``weights.py``'s dense
law, N(0, 0.02) a stored element, would shrink every layer's output some
fifty times over. Biases 0, the style affines' 1 (their ``bias_init``);
noise strengths 0, as ``weights.py`` has them; the ``noise_const`` planes
unit normal; ``w_avg`` 0. The names are the port's, so the state loads into
the program's net (``load_state_dict``) and the reference's alike.

One departure, for the weights to stand for a trained generator, whose fill
is an image: the toRGB kernels are drawn at ``TO_RGB_STD`` = 0.1, not 1.
With the published init a 512 forward fills a hole in a [-1, 1] image at an
RMS of 3.2, and of 44 where the image is ten times larger: the toRGB layers
are modulated and not demodulated, and the first stage's fill enters the
second stage's encoder, so the fill grows faster than its input. test_mat.sh
feeds MAT's fill of the reference frame into the input of every predicted
frame's MAT, and there such a fill compounds: the TF32 reference read gaps of
1e1-1e7 (mean over a clip's videos) against the float32 one. At 0.1 the fill
is 0.19 RMS and 0.89 on the ten times larger image."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# the toRGB layers' kernels (modulated 1x1 convs, not demodulated), against
# the published init's 1: see the module's docstring
TO_RGB_STD = 0.1


def layout(resolution: int = 512) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(name, shape, std, offset) of every parameter and persistent buffer
    of the plain MAT at ``resolution``, in a fixed order."""
    from plainref.models.mat import FullyConnectedLayer, Generator

    with torch.device("meta"):
        net = Generator(img_resolution=resolution)
    out = []
    for name, t in list(net.named_parameters()) + [
            (n, b) for n, b in net.named_buffers() if not n.endswith("resample_filter")]:
        mod, _, leaf = name.rpartition(".")
        owner = net.get_submodule(mod)
        fc = isinstance(owner, FullyConnectedLayer)
        if name.endswith("toRGB.conv.weight"):
            law = (TO_RGB_STD, 0.0)
        elif leaf == "weight":
            law = (1.0 / owner.lr_multiplier if fc else 1.0, 0.0)
        elif leaf == "bias":
            law = (0.0, owner.bias_init if fc else 0.0)
        elif leaf == "noise_const":
            law = (1.0, 0.0)
        elif leaf in ("noise_strength", "w_avg"):
            law = (0.0, 0.0)
        else:
            raise ValueError(f"no law for MAT's {name} {tuple(t.shape)}")
        out.append((name, tuple(t.shape)) + law)
    return out


def make(seed: int, device, resolution: int = 512) -> Dict[str, torch.Tensor]:
    """{name: tensor} of MAT's state at ``resolution``, drawn from ``seed``
    on ``device``."""
    lay = layout(resolution)
    sizes = [int(torch.Size(s).numel()) for _, s, _, _ in lay]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    counts = torch.tensor(sizes, device=device)
    flat = (flat.mul_(torch.repeat_interleave(torch.tensor([l[2] for l in lay], device=device),
                                               counts))
            .add_(torch.repeat_interleave(torch.tensor([l[3] for l in lay], device=device),
                                          counts)))
    return {name: part.view(shape) for (name, shape, _, _), part in zip(lay, flat.split(sizes))}
