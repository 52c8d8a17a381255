"""Sequence sharding over the "seq" axis of the process grid (counterpart of
waldo_tpu/parallel/sharding.py).

The JAX package annotates the token axis of three attention stacks with a
"seq" mesh axis and lets XLA partition them (LVD's pose estimator and its
object extractor's context tokens, FLP's pose encoder). Here the S ranks of
a seq line (parallel/mesh.py) split such a stream's tokens: each holds a
contiguous 1/S of them (``TokenShard``), computes the stack's norms, MLPs
and queries on its own tokens, and gathers the keys and values of the
sharded stream from the line, in seq-rank order, so every query's softmax
runs over world 1's keys in world 1's order. The stack's output is gathered
where the JAX package's replicated consumers read it. A stream whose token
count S does not divide stays whole, as the JAX package drops an axis that
does not divide. Where no seq axis of S > 1 is up, everything here is the
identity.

The gradients: a gather's backward sums the line's gradients and keeps the
rank's part, so the gradient a rank computes, summed over its seq line, is
S times the line's (the line's ranks hold the same loss): the train step's
one all-reduce over the world, divided by W = D S, gives world 1's mean
(train/train_state.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import mesh


@dataclass(frozen=True)
class TokenShard:
    """The tokens [offset, offset + size) of a stream of ``total`` tokens
    that one of ``world`` seq ranks holds."""

    offset: int
    size: int
    total: int
    world: int = 1

    @classmethod
    def whole(cls, n: int) -> "TokenShard":
        return cls(0, n, n, 1)

    @classmethod
    def of_rank(cls, n: int) -> "TokenShard":
        """This seq rank's part of a stream of ``n`` tokens: whole where no
        seq axis of S > 1 is up or S does not divide ``n``."""
        s = mesh.seq_world()
        if s == 1 or n % s:
            return cls.whole(n)
        size = n // s
        return cls(mesh.seq_rank() * size, size, n, s)

    @property
    def sharded(self) -> bool:
        return self.world > 1

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's tokens (dim 1) of a tensor over the whole stream."""
        return x.narrow(1, self.offset, self.size) if self.sharded else x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole stream of a tensor over the rank's tokens (dim 1), in
        seq-rank order, differentiable."""
        return mesh.all_gather(x, 1, mesh.seq_group()) if self.sharded else x

    def randn(self, stream, shape, device) -> torch.Tensor:
        """A draw of ``stream`` (``randn(shape, device)``) for the rank's
        tokens: made at the stream's global token count and sliced, so the
        numbers are world 1's."""
        if not self.sharded:
            return stream.randn(shape, device)
        shape = (shape[0], self.total) + tuple(shape[2:])
        return self.shard(stream.randn(shape, device))


def token_shard(n: int, sharded: bool) -> TokenShard:
    """``TokenShard.of_rank(n)`` where the caller shards its tokens, else the
    whole stream."""
    return TokenShard.of_rank(n) if sharded else TokenShard.whole(n)


def shard_tokens(x: torch.Tensor) -> torch.Tensor:
    """This seq rank's contiguous 1/S of ``x``'s tokens (dim 1); ``x`` whole
    where no seq axis of S > 1 is up or S does not divide dim 1."""
    return TokenShard.of_rank(x.shape[1]).shard(x)


def gather_tokens(x: torch.Tensor, total: int) -> torch.Tensor:
    """The inverse of ``shard_tokens`` for a stream of ``total`` tokens,
    differentiable."""
    return TokenShard.of_rank(total).gather(x)


def shard_batch_only(x: torch.Tensor) -> torch.Tensor:
    """The identity: a rank's batch is already its data coordinate's rows."""
    return x

