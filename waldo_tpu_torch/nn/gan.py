"""GAN losses, spectral norms and the inpainting discriminator (counterpart
of waldo_tpu/nn/gan.py).

The losses take logits or lists of multi-scale logits (the mean of the
per-scale losses) and return 0-d tensors: "original" (binary cross-entropy
on logits), "hinge" (the one the synthesizer uses), "logistic", "wgan" and
"wgan-eps". ``wgan_gradient_penalty`` draws its interpolation weights from
an explicit ``torch.Generator`` (or takes them drawn) and differentiates
through the discriminator's input gradient (``create_graph=True``).

The spectral norms keep their state in buffers: ``ImprovedSpectralDense``
(the JAX package's "isn": the kernel over its running spectral norm times
the norm at init, one power iteration a call) and ``SpectralNormDense``
(flax's ``nn.SpectralNorm`` around a Dense, the "sn" variant: one power
iteration, eps 1e-12, the ``batch_stats`` ``u`` and ``sigma``), written out
here; ``torch.nn.utils.spectral_norm`` keeps other state and updates it by
another rule.

``Discriminator`` is the JAX package's patch discriminator: four 4x4
stride-2 convolutions with padding 1 and 64 * 2^i channels, a per-channel
norm (``CustomNorm("ln2d")``) after all but the first, LeakyReLU 0.2, then a
4x4 stride-1 convolution to one logit map. Its convolutions are plain
``F.conv2d``: the JAX package computes them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .init import resolve_dtype, trunc_normal_, xavier_uniform_
from .transform import CustomNorm, Dense


# ---------------------------------------------------------------------------
# losses on logits
# ---------------------------------------------------------------------------

def _map_logits(fn, d):
    if isinstance(d, (list, tuple)):
        return torch.stack([fn(x) for x in d]).mean()
    return fn(d)


def _bce_with_logits(logits, target):
    return logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))


def original_g_loss(d_fake):
    return _map_logits(lambda d: _bce_with_logits(d, torch.ones_like(d)).mean(), d_fake)


def original_d_loss(d_real, d_fake):
    lr = _map_logits(lambda d: _bce_with_logits(d, torch.ones_like(d)).mean(), d_real)
    lf = _map_logits(lambda d: _bce_with_logits(d, torch.zeros_like(d)).mean(), d_fake)
    return lr + lf


def hinge_g_loss(d_fake):
    return _map_logits(lambda d: (-d).mean(), d_fake)


def hinge_d_loss(d_real, d_fake):
    lr = _map_logits(lambda d: F.relu(1.0 - d).mean(), d_real)
    lf = _map_logits(lambda d: F.relu(1.0 + d).mean(), d_fake)
    return lr + lf


def logistic_g_loss(d_fake):
    return _map_logits(lambda d: F.softplus(-d).mean(), d_fake)


def logistic_d_loss(d_real, d_fake):
    lr = _map_logits(lambda d: F.softplus(-d).mean(), d_real)
    lf = _map_logits(lambda d: F.softplus(d).mean(), d_fake)
    return lr + lf


def wgan_g_loss(d_fake):
    return _map_logits(lambda d: (-d).mean(), d_fake)


def wgan_d_loss(d_real, d_fake, gradient_penalty=0.0, lambda_gp=10.0, eps_penalty=0.0):
    lr = _map_logits(lambda d: (-d).mean(), d_real)
    lf = _map_logits(lambda d: d.mean(), d_fake)
    return lr + lf + lambda_gp * gradient_penalty + eps_penalty


def wgan_gradient_penalty(disc: Callable, x_real, x_fake,
                          generator: Optional[torch.Generator] = None,
                          eps: Optional[torch.Tensor] = None):
    """The WGAN-GP penalty: the mean over the batch of (|grad_x D(x_hat)| -
    1)^2 at x_hat = eps x_real + (1 - eps) x_fake, eps uniform per sample,
    drawn from ``generator`` unless given (shape (B, 1, ..., 1)).
    Differentiable in D's parameters and in the inputs."""
    if eps is None:
        shape = (x_real.shape[0],) + (1,) * (x_real.dim() - 1)
        eps = torch.rand(shape, generator=generator, device=x_real.device)
    x_hat = eps * x_real + (1 - eps) * x_fake
    if not x_hat.requires_grad:
        x_hat = x_hat.detach().requires_grad_(True)
    d = disc(x_hat)
    score = sum(di.sum() for di in d) if isinstance(d, (list, tuple)) else d.sum()
    (g,) = torch.autograd.grad(score, x_hat, create_graph=True)
    norms = torch.sqrt((g.reshape(g.shape[0], -1) ** 2).sum(-1) + 1e-12)
    return ((norms - 1.0) ** 2).mean()


GAN_LOSSES = {
    "original": (original_g_loss, original_d_loss),
    "hinge": (hinge_g_loss, hinge_d_loss),
    "logistic": (logistic_g_loss, logistic_d_loss),
    "wgan": (wgan_g_loss, wgan_d_loss),
    "wgan-eps": (wgan_g_loss, wgan_d_loss),
}


def get_gan_loss(name: str):
    """(generator loss, discriminator loss) of a GAN loss by name."""
    return GAN_LOSSES[name]


# ---------------------------------------------------------------------------
# spectral norms
# ---------------------------------------------------------------------------

def _l2_normalize(x, eps):
    return x * torch.rsqrt((x * x).sum() + eps)


class ImprovedSpectralDense(nn.Module):
    """Dense layer under the improved spectral norm (arXiv:2107.04589): the
    kernel divided by its spectral norm, from one power iteration on the
    buffer ``u``, times ``sigma_init``, that norm at initialization. A call
    with ``update_stats`` stores the iteration's new ``u``. Weight layout
    (out, in), as ``Dense``'s."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.register_buffer("u", torch.empty(features))
        self.register_buffer("sigma_init", torch.ones(()))

    def _power_iteration(self):
        kernel = self.weight.t()  # (in, out)
        v = kernel @ self.u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u_new = kernel.t() @ v
        return u_new, torch.linalg.vector_norm(u_new) + 1e-12

    @torch.no_grad()
    def init_parameters(self, generator):
        trunc_normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()
        self.u.copy_(torch.randn(self.u.shape, generator=generator))
        self.sigma_init.copy_(self._power_iteration()[1])

    def forward(self, x, update_stats: bool = True):
        u_new, sigma = self._power_iteration()
        y = x @ (self.weight.t() / sigma * self.sigma_init)
        if update_stats:
            self.u = (u_new / sigma).detach()  # rebound: the graph keeps the old u
        return y + self.bias if self.bias is not None else y


class SpectralNormDense(nn.Module):
    """flax's ``nn.SpectralNorm(nn.Dense(features))``: the kernel (in, out)
    divided by sigma = v K u^T from one power iteration (u (1, out) and v
    L2-normalized with eps 1e-12, held constant under differentiation);
    ``update_stats`` stores the new ``u`` and ``sigma`` (the buffers of flax's
    ``batch_stats`` "layer_instance/kernel/u" and ".../sigma"). Weight
    layout (out, in)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.register_buffer("u", torch.empty(1, features))
        self.register_buffer("sigma", torch.ones(()))

    @torch.no_grad()
    def init_parameters(self, generator):
        trunc_normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()
        self.u.copy_(torch.randn(self.u.shape, generator=generator))

    def forward(self, x, update_stats: bool = True):
        value = self.weight.t()  # (in, out)
        with torch.no_grad():
            v0 = _l2_normalize(self.u @ value.t(), 1e-12)
            u0 = _l2_normalize(v0 @ value, 1e-12)
        sigma = (v0 @ value @ u0.t())[0, 0]
        y = x @ (value / torch.where(sigma != 0, sigma, torch.ones_like(sigma)))
        if update_stats:
            self.u, self.sigma = u0, sigma.detach()
        return y + self.bias if self.bias is not None else y


def spectral_dense(kind: str, in_features: int, features: int, **kw):
    """A dense layer under the spectral norm ``kind``: "sn" (flax's
    SpectralNorm), "isn" (the improved one) or none."""
    if kind == "sn":
        return SpectralNormDense(in_features, features, **kw)
    if kind == "isn":
        return ImprovedSpectralDense(in_features, features)
    return Dense(in_features, features, **kw)


# ---------------------------------------------------------------------------
# the discriminator ("id")
# ---------------------------------------------------------------------------

class _PatchConv(nn.Module):
    """4x4 convolution with bias, padding 1, float32 parameters computed in
    ``dtype`` on channel-first input."""

    def __init__(self, in_ch, out_ch, stride, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 4, 4))
        self.bias = nn.Parameter(torch.empty(out_ch))
        self.stride = stride
        self.dtype = dtype

    def init_parameters(self, generator):
        xavier_uniform_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype),
                        stride=self.stride, padding=1)


class Discriminator(nn.Module):
    """Patch discriminator: images (B, H, W, 3) channel-last -> logits
    (B, H/16 - 1, W/16 - 1, 1)."""

    def __init__(self, base_dim: int = 64, depth: int = 4, in_channels: int = 3,
                 dtype=torch.float32):
        super().__init__()
        dtype = resolve_dtype(dtype)
        chans = [in_channels] + [base_dim * 2 ** i for i in range(depth)]
        self.convs = nn.ModuleList(_PatchConv(chans[i], chans[i + 1], 2, dtype)
                                   for i in range(depth))
        self.convs.append(_PatchConv(chans[-1], 1, 1, dtype))
        self.norms = nn.ModuleList(CustomNorm("ln2d", c) for c in chans[2:])

    def forward(self, x):
        x = x.movedim(-1, 1)
        for i, conv in enumerate(self.convs[:-1]):
            x = conv(x)
            if i > 0:
                x = self.norms[i - 1].forward_nchw(x)
            x = F.leaky_relu(x, 0.2)
        return self.convs[-1](x).movedim(1, -1)
