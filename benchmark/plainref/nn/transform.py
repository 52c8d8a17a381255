"""Transformer blocks and the attention types of the predict path
(counterpart of waldo_tpu/nn/transform.py).

Attention is a plain matmul + softmax, as the JAX ``_mha`` writes it: the
logits are taken in float32, masked keys get -1e9 (never -inf, so a fully
masked row cannot turn to NaN), and the probabilities return to the compute
dtype for the value product. Ported types: ``full``, ``cross``, ``obj`` and
``cls``; the others raise until they are ported.

``SkipAttention`` and ``Skip2Attention`` drop context frames in training
(``temporal_dropout``) by draws from an explicit ``torch.Generator``.

Training-time token noise (FLP's ``pg_inject_noise``): an attention built
with ``noise=True`` adds ``N(0, 1) * noise_strength``, one draw per token, to
its input when its caller hands it a ``noise`` stream (the JAX package's
``deterministic=False`` with a "noise" stream): an object whose
``randn(shape, device)`` draws, such as ``parallel.RowStream``, which draws
at the global batch's shape and keeps the rank's rows; without one it adds
none.

Sequence sharding (parallel/sharding.py): a ``Block`` or ``MultiBlocks``
handed a ``tokens`` shard (a ``parallel.TokenShard``) runs on this seq
rank's part of a sharded stream: x for ``full`` (its queries stay local,
its keys and values are gathered from the seq line before ``_mha``), x_ctx
for ``obj`` (the keys and values of the context are gathered; x, the
object queries, is replicated). A ``key_mask`` stays over the whole
stream, as the gathered keys are. Norms and MLPs are per token. Token noise
on a sharded x is drawn at the whole stream's shape and sliced.
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


def _add_noise(x, strength, noise, tokens=None):
    """x (B, N, C) plus one N(0, 1) draw per token from the stream
    ``noise`` times ``strength``; x itself where either is None. Where x is
    a ``tokens`` shard, the draw is the whole stream's, sliced."""
    if strength is None or noise is None:
        return x
    shape = tuple(x.shape[:2]) + (1,)
    eps = (noise.randn(shape, x.device) if tokens is None
           else tokens.randn(noise, shape, x.device))
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

    def forward(self, x, x_ctx=None, key_mask=None, noise=None, tokens=None):
        x = _add_noise(x, self.noise_strength, noise, tokens)
        qkv = self.qkv(x)
        c = qkv.shape[-1] // 3
        q, kv = qkv[..., :c], qkv[..., c:]
        if tokens is not None:  # x is a shard: the seq line's keys and values
            kv = tokens.gather(kv)
        k, v = kv.chunk(2, dim=-1)
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

    def forward(self, x, x_ctx=None, key_mask=None, noise=None, tokens=None):
        k_obj, v_obj = self.kv(x).chunk(2, dim=-1)
        kv_ctx = self.kv(x_ctx)
        if tokens is not None:  # x_ctx is a shard
            kv_ctx = tokens.gather(kv_ctx)
        k_ctx, v_ctx = kv_ctx.chunk(2, dim=-1)
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


class CtxAttention(nn.Module):
    """Context tokens attend to [x; x_ctx]: queries over x_ctx, keys and
    values over both (the JAX package's naming: x is the cls token)."""

    def __init__(self, dim, num_heads, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q = Dense(dim, dim, bias=False, dtype=dtype)
        self.kv = Dense(dim, dim * 2, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x, x_ctx=None, key_mask=None, noise=None):
        k, v = self.kv(torch.cat([x, x_ctx], dim=1)).chunk(2, dim=-1)
        return self.proj(_mha(self.q(x_ctx), k, v, self.num_heads))


class SeedAttention(nn.Module):
    """Self-attention with one more key/value pair per cls token of
    ``z_cls``, put before the tokens' own."""

    def __init__(self, dim, num_heads, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, dim * 3, bias=False, dtype=dtype)
        self.kv_cls = Dense(dim, dim * 2, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x, z_cls):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        k_cls, v_cls = self.kv_cls(z_cls).chunk(2, dim=-1)
        k = torch.cat([k_cls, k], dim=1)
        v = torch.cat([v_cls, v], dim=1)
        return self.proj(_mha(q, k, v, self.num_heads))


def get_causal_mask(causal_mask_sizes, mask_diag=False, device=None):
    """The block-causal mask of blocks of the given sizes, True where a
    query may not attend (a later block; with ``mask_diag`` its own too)."""
    block = torch.cat([torch.full((s,), i) for i, s in enumerate(causal_mask_sizes)])
    row, col = block[:, None], block[None, :]
    return ((row <= col) if mask_diag else (row < col)).to(device)


class BlockCausalAttention(nn.Module):
    """Self-attention under the block-causal mask of ``causal_mask_sizes``,
    its logits in the compute dtype, as the JAX package takes them."""

    def __init__(self, dim, num_heads, causal_mask_sizes=(), dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.causal_mask_sizes = tuple(causal_mask_sizes)
        self.qkv = Dense(dim, dim * 3, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x, x_ctx=None, key_mask=None, noise=None):
        b, n, c = x.shape
        d = c // self.num_heads
        qh, kh, vh = (t.reshape(b, n, self.num_heads, d).transpose(1, 2)
                      for t in self.qkv(x).chunk(3, dim=-1))
        attn = torch.matmul(qh, kh.transpose(-1, -2)) * (d ** -0.5)
        mask = get_causal_mask(self.causal_mask_sizes, device=x.device)[:n, :n]
        attn = attn.masked_fill(mask, _NEG).softmax(dim=-1)
        out = torch.matmul(attn, vh).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class _SkipBase(nn.Module):
    """What the two skip attentions share: the projections, the context
    masks and the softmax over the context blocks and the frame's own."""

    def __init__(self, dim, num_heads, latent_size, num_seeds=0, temporal_dropout=0.0,
                 non_trivial=False, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.latent_size = latent_size
        self.num_seeds = num_seeds
        self.temporal_dropout = temporal_dropout
        self.non_trivial = non_trivial
        self.qkv = Dense(dim, dim * 3, bias=False, dtype=dtype)
        self.k_ctx = Dense(dim, dim, bias=False, dtype=dtype)
        self.v_ctx = Dense(dim, dim, bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def _mask(self, attn, t0, t, mode, ctx_mask, generator):
        """attn (B, hn, T0*L, T, L): masked context keys, the non-trivial
        mask (query frame t0 never sees context frame t0 + num_seeds) and,
        in training with a generator, temporal dropout of whole context
        frames per query."""
        l = self.latent_size
        if ctx_mask is not None:
            attn = attn.masked_fill(~ctx_mask[:, None, None, :, None], _NEG)
        if mode == "training" and self.non_trivial:
            idx = torch.arange(t, device=attn.device)
            m = (idx[:, None] + self.num_seeds) == idx[None, :]
            m = m[:t0].repeat_interleave(l, dim=0)  # T0*L, T
            attn = attn.masked_fill(m[None, None, :, :, None], _NEG)
        if mode == "training" and self.temporal_dropout > 0 and generator is not None:
            drop = torch.rand(tuple(attn.shape[:-1]) + (1,), generator=generator,
                              device=attn.device) < self.temporal_dropout
            attn = attn.masked_fill(drop, _NEG)
        return attn

    def _attend(self, attn, qh, k, v, vc, b, t0, t):
        """Softmax over [context blocks; the frame's own block] and the value
        product; qh (B, hn, T0, L, d), k/v (B, T0*L, C), vc (B, hn, T*L, d)."""
        l, hn = self.latent_size, self.num_heads
        c = k.shape[-1]
        d = c // hn
        kh = k.reshape(b, t0, l, hn, d).permute(0, 3, 1, 2, 4)
        vh = v.reshape(b, t0, l, hn, d).permute(0, 3, 1, 2, 4)
        self_attn = (torch.matmul(qh, kh.transpose(-1, -2)) * (d ** -0.5)).reshape(
            b, hn, t0 * l, 1, l)
        full = torch.cat([attn, self_attn], dim=3).reshape(b, hn, t0 * l, (t + 1) * l)
        full = full.softmax(dim=-1)
        out = torch.matmul(full[..., :t * l], vc)
        self_part = torch.matmul(full[..., t * l:].reshape(b, hn, t0, l, l), vh)
        out = out + self_part.reshape(b, hn, t0 * l, d)
        return self.proj(out.transpose(1, 2).reshape(b, t0 * l, c))


class SkipAttention(_SkipBase):
    """Per-frame queries x (B, T0*L, C) over T context frames of L tokens,
    keyed by dx_ctx and valued by x_ctx (B, T, L, C), and over their own
    frame's tokens."""

    def forward(self, x, x_ctx, dx_ctx, mode="inference", ctx_mask=None,
                generator: Optional[torch.Generator] = None):
        l, hn = self.latent_size, self.num_heads
        b, t, _, c = x_ctx.shape
        t0 = x.shape[1] // l
        d = c // hn
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        qh = q.reshape(b, t0 * l, hn, d).transpose(1, 2)
        kc = self.k_ctx(dx_ctx).reshape(b, t * l, hn, d).transpose(1, 2)
        vc = self.v_ctx(x_ctx).reshape(b, t * l, hn, d).transpose(1, 2)
        attn = (torch.matmul(qh, kc.transpose(-1, -2)) * (d ** -0.5)).reshape(b, hn, t0 * l, t, l)
        attn = self._mask(attn, t0, t, mode, ctx_mask, generator)
        return self._attend(attn, qh.reshape(b, hn, t0, l, d), k, v, vc, b, t0, t)


class Skip2Attention(_SkipBase):
    """SkipAttention with a key per (context frame, query frame): dx_ctx
    (B, T, T0*L, C), so the queries of frame t0 meet context frame t through
    dx_ctx[:, t, t0*L:(t0+1)*L]."""

    def forward(self, x, x_ctx, dx_ctx, mode="inference", ctx_mask=None,
                generator: Optional[torch.Generator] = None):
        l, hn = self.latent_size, self.num_heads
        b, t, n, c = dx_ctx.shape
        t0 = n // l
        d = c // hn
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        kc = self.k_ctx(dx_ctx).reshape(b, t, t0, l, hn, d).permute(0, 4, 2, 1, 3, 5)
        vc = self.v_ctx(x_ctx).reshape(b, t * l, hn, d).transpose(1, 2)
        qh = q.reshape(b, t0, l, hn, d).permute(0, 3, 1, 2, 4)  # B hn T0 L d
        attn = torch.einsum("bhoqd,bhotkd->bhotqk", qh, kc) * (d ** -0.5)
        attn = attn.permute(0, 1, 2, 4, 3, 5).reshape(b, hn, t0 * l, t, l)
        attn = self._mask(attn, t0, t, mode, ctx_mask, generator)
        return self._attend(attn, qh, k, v, vc, b, t0, t)


# the JAX package's Block raises TypeError for these (waldo_tpu/nn/transform.py)
_NOT_IN_A_BLOCK = {
    "seed": "SeedAttention needs z_cls, and Block calls every attention as attn(h, "
            "x_ctx=..., key_mask=...) (:401): TypeError \"missing 'z_cls'\"",
    "skip": "Block never passes SkipAttention's latent_size (:393-397): TypeError at "
            "construction",
    "skip2": "Block never passes Skip2Attention's latent_size (:393-397): TypeError at "
             "construction",
}


def _attention(block_type, dim, num_heads, noise, dtype, causal_mask_sizes=()):
    if block_type in ("full", "full_with_cond_norm"):
        return FullAttention(dim, num_heads, noise=noise, dtype=dtype)
    if block_type == "cross":
        return CrossAttention(dim, num_heads, noise=noise, dtype=dtype)
    if block_type == "obj":
        return ObjAttention(dim, num_heads, dtype=dtype)
    if block_type == "cls":
        return ClsAttention(dim, num_heads, dtype=dtype)
    if block_type == "ctx":
        return CtxAttention(dim, num_heads, dtype=dtype)
    if block_type == "block_causal":
        return BlockCausalAttention(dim, num_heads, causal_mask_sizes, dtype=dtype)
    if block_type in _NOT_IN_A_BLOCK:
        raise NotImplementedError(
            f"attention type {block_type!r} cannot run in a Block, as in the JAX package: "
            f"{_NOT_IN_A_BLOCK[block_type]}; use the module standalone")
    raise ValueError(f"unknown attention type {block_type!r}")


class Mlp(nn.Module):
    def __init__(self, dim, mul=4, out_dim=None, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, mul * dim, dtype=dtype)
        self.fc2 = Dense(mul * dim, out_dim or dim, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


# the attention types a Block runs on a sharded stream: x for "full", x_ctx
# for "obj" (the JAX package shards no other)
_SHARDABLE = ("full", "obj")


class Block(nn.Module):
    """Pre-norm transformer block; ``full_with_cond_norm`` modulates the two
    norms by an Mlp of ``z_cond`` (B, 1, C). With ``tokens`` (a
    ``parallel.TokenShard``) it runs on the seq rank's part of the sharded
    stream (the module docstring)."""

    def __init__(self, dim, num_heads, block_type="full", norm_layer="ln",
                 noise=False, dtype=torch.float32, causal_mask_sizes=()):
        super().__init__()
        self.cond = (Mlp(dim, out_dim=4 * dim, dtype=dtype)
                     if block_type == "full_with_cond_norm" else None)
        self.norm1 = CustomNorm(norm_layer, dim)
        self.attn = _attention(block_type, dim, num_heads, noise, dtype, causal_mask_sizes)
        self.norm2 = CustomNorm(norm_layer, dim)
        self.mlp = Mlp(dim, dtype=dtype)
        self.block_type = block_type

    def forward(self, x, x_ctx=None, key_mask=None, noise=None, z_cond=None, tokens=None):
        if self.cond is None:
            h = self.norm1(x)
        else:
            a1, b1, a2, b2 = self.cond(z_cond).reshape(x.shape[0], 1, 4, -1).unbind(2)
            h = a1 * self.norm1(x) + b1
        if tokens is None:
            x = x + self.attn(h, x_ctx=x_ctx, key_mask=key_mask, noise=noise)
        elif self.block_type in _SHARDABLE:
            x = x + self.attn(h, x_ctx=x_ctx, key_mask=key_mask, noise=noise, tokens=tokens)
        else:
            raise ValueError(f"a {self.block_type!r} block cannot run on sharded tokens")
        h = self.norm2(x)
        if self.cond is not None:
            h = a2 * h + b2
        return x + self.mlp(h)


class MultiBlocks(nn.Module):
    def __init__(self, depth, dim, num_heads, block_type="full", norm_layer="ln",
                 noise=False, dtype=torch.float32, causal_mask_sizes=()):
        super().__init__()
        self.layers = nn.ModuleList(
            Block(dim, num_heads, block_type, norm_layer, noise, dtype, causal_mask_sizes)
            for _ in range(depth))

    def forward(self, x, x_ctx=None, key_mask=None, z_cond=None, tokens=None):
        for blk in self.layers:
            x = blk(x, x_ctx=x_ctx, key_mask=key_mask, z_cond=z_cond, tokens=tokens)
        return x
