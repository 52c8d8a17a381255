"""Transformer blocks and the attention types of the predict path
(counterpart of waldo_tpu/nn/transform.py).

Attention is a plain matmul + softmax, as the JAX ``_mha`` writes it: the
logits are taken in float32, masked keys get -1e9 (never -inf, so a fully
masked row cannot turn to NaN), and the probabilities return to the compute
dtype for the value product. Ported types: ``full``, ``cross``, ``obj`` and
``cls``; the others raise until they are ported.

Training-time token noise (FLP's ``pg_inject_noise``): an attention built
with ``noise=True`` adds ``N(0, 1) * noise_strength``, one draw per token, to
its input when its caller hands it a ``noise`` stream (the JAX package's
``deterministic=False`` with a "noise" stream): an object whose
``randn(shape, device)`` draws, such as ``parallel.RowStream``, which draws
at the global batch's shape and keeps the rank's rows; without one it adds
none.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .init import resolve_dtype, trunc_normal_

_NEG = -1e9


class Dense(nn.Module):
    """Linear layer with float32 parameters that computes in ``dtype``
    (flax ``Dense(dtype=...)``). Weight layout (out, in)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, zero_init: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.dtype = resolve_dtype(dtype)
        self.zero_init = zero_init

    def init_parameters(self, generator):
        if self.zero_init:
            self.weight.zero_()
        else:
            trunc_normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        b = self.bias.to(self.dtype) if self.bias is not None else None
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class CustomNorm(nn.Module):
    """ln / ln_not_affine / pn / ln2d with eps 1e-5, computed in float32.

    ``forward`` takes channel-last input (..., C). The conv modules run
    channel-first and call ``forward_nchw``; there "ln2d" is a per-channel
    norm over the spatial dims (GroupNorm(C, C))."""

    def __init__(self, norm_type: str, dim: int):
        super().__init__()
        if norm_type not in ("ln", "ln_not_affine", "pn", "ln2d"):
            raise ValueError(norm_type)
        self.norm_type = norm_type
        affine = norm_type in ("ln", "ln2d")
        self.weight = nn.Parameter(torch.empty(dim)) if affine else None
        self.bias = nn.Parameter(torch.empty(dim)) if affine else None

    def init_parameters(self, generator):
        if self.weight is not None:
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        x = x.float()
        if self.norm_type in ("ln", "ln_not_affine"):
            return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, 1e-5)
        if self.norm_type == "pn":
            return x * torch.rsqrt((x ** 2).mean(-1, keepdim=True) + 1e-8)
        return self.forward_nchw(x.movedim(-1, 1)).movedim(1, -1)

    def forward_nchw(self, x):
        x = x.float()
        if self.norm_type == "ln2d":
            return F.group_norm(x, x.shape[1], self.weight, self.bias, 1e-5)
        return self.forward(x.movedim(1, -1)).movedim(-1, 1)


def _mha(q, k, v, num_heads: int, key_mask: Optional[torch.Tensor] = None):
    """q (B,Nq,C), k/v (B,Nk,C), key_mask (B,Nk) True = attend -> (B,Nq,C)."""
    b, nq, c = q.shape
    d = c // num_heads
    qh = q.reshape(b, nq, num_heads, d).transpose(1, 2)
    kh = k.reshape(b, k.shape[1], num_heads, d).transpose(1, 2)
    vh = v.reshape(b, v.shape[1], num_heads, d).transpose(1, 2)
    attn = torch.matmul(qh, kh.transpose(-1, -2)).float() * (d ** -0.5)
    if key_mask is not None:
        attn = attn.masked_fill(~key_mask[:, None, None, :], _NEG)
    attn = attn.softmax(dim=-1).to(qh.dtype)
    out = torch.matmul(attn, vh)
    return out.transpose(1, 2).reshape(b, nq, c)


def _add_noise(x, strength, noise):
    """x (B, N, C) plus one N(0, 1) draw per token from the stream
    ``noise`` times ``strength``; x itself where either is None."""
    if strength is None or noise is None:
        return x
    eps = noise.randn(tuple(x.shape[:2]) + (1,), x.device)
    return x + eps * strength


class FullAttention(nn.Module):
    """Self-attention with an optional key mask."""

    def __init__(self, dim, num_heads, noise=False, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, dim * 3, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.noise_strength = nn.Parameter(torch.empty(())) if noise else None

    def init_parameters(self, generator):
        if self.noise_strength is not None:
            self.noise_strength.zero_()

    def forward(self, x, x_ctx=None, key_mask=None, noise=None):
        x = _add_noise(x, self.noise_strength, noise)
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(_mha(q, k, v, self.num_heads, key_mask))


class CrossAttention(nn.Module):
    """Queries over x, keys and values over x_ctx."""

    def __init__(self, dim, num_heads, noise=False, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q = Dense(dim, dim, bias=False, dtype=dtype)
        self.kv = Dense(dim, dim * 2, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.noise_strength = nn.Parameter(torch.empty(())) if noise else None

    def init_parameters(self, generator):
        if self.noise_strength is not None:
            self.noise_strength.zero_()

    def forward(self, x, x_ctx=None, key_mask=None, noise=None):
        x = _add_noise(x, self.noise_strength, noise)
        k, v = self.kv(x_ctx).chunk(2, dim=-1)
        return self.proj(_mha(self.q(x), k, v, self.num_heads, key_mask))


class ObjAttention(nn.Module):
    """Object queries attending to themselves and the frame tokens (one
    key/value projection shared by both)."""

    def __init__(self, dim, num_heads, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q = Dense(dim, dim, bias=False, dtype=dtype)
        self.kv = Dense(dim, dim * 2, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x, x_ctx=None, key_mask=None, noise=None):
        k_obj, v_obj = self.kv(x).chunk(2, dim=-1)
        k_ctx, v_ctx = self.kv(x_ctx).chunk(2, dim=-1)
        k = torch.cat([k_obj, k_ctx], dim=1)
        v = torch.cat([v_obj, v_ctx], dim=1)
        return self.proj(_mha(self.q(x), k, v, self.num_heads))


class ClsAttention(nn.Module):
    """CLS-token pooling: queries over x, keys and values over [x; x_ctx]."""

    def __init__(self, dim, num_heads, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q = Dense(dim, dim, bias=False, dtype=dtype)
        self.kv = Dense(dim, dim * 2, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x, x_ctx=None, key_mask=None, noise=None):
        z = torch.cat([x, x_ctx], dim=1)
        k, v = self.kv(z).chunk(2, dim=-1)
        return self.proj(_mha(self.q(x), k, v, self.num_heads))


def _attention(block_type, dim, num_heads, noise, dtype):
    if block_type == "full":
        return FullAttention(dim, num_heads, noise=noise, dtype=dtype)
    if block_type == "cross":
        return CrossAttention(dim, num_heads, noise=noise, dtype=dtype)
    if block_type == "obj":
        return ObjAttention(dim, num_heads, dtype=dtype)
    if block_type == "cls":
        return ClsAttention(dim, num_heads, dtype=dtype)
    raise NotImplementedError(f"attention type {block_type!r} is not ported yet")


class Mlp(nn.Module):
    def __init__(self, dim, mul=4, out_dim=None, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, mul * dim, dtype=dtype)
        self.fc2 = Dense(mul * dim, out_dim or dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm transformer block."""

    def __init__(self, dim, num_heads, block_type="full", norm_layer="ln",
                 noise=False, dtype=torch.float32):
        super().__init__()
        self.norm1 = CustomNorm(norm_layer, dim)
        self.attn = _attention(block_type, dim, num_heads, noise, dtype)
        self.norm2 = CustomNorm(norm_layer, dim)
        self.mlp = Mlp(dim, dtype=dtype)

    def forward(self, x, x_ctx=None, key_mask=None, noise=None):
        x = x + self.attn(self.norm1(x), x_ctx=x_ctx, key_mask=key_mask, noise=noise)
        return x + self.mlp(self.norm2(x))


class MultiBlocks(nn.Module):
    def __init__(self, depth, dim, num_heads, block_type="full", norm_layer="ln",
                 noise=False, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(dim, num_heads, block_type, norm_layer, noise, dtype)
            for _ in range(depth))

    def forward(self, x, x_ctx=None, key_mask=None):
        for blk in self.layers:
            x = blk(x, x_ctx=x_ctx, key_mask=key_mask)
        return x
