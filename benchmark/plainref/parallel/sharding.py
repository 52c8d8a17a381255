"""The whole token stream, always: the reference runs in one process."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class TokenShard:
    """A whole stream of ``total`` tokens."""

    offset: int
    size: int
    total: int
    world: int = 1

    @property
    def sharded(self) -> bool:
        return False

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def randn(self, stream, shape, device) -> torch.Tensor:
        return stream.randn(shape, device)


def token_shard(n: int, sharded: bool) -> TokenShard:
    if sharded:
        raise ValueError("the reference runs on whole token streams")
    return TokenShard(0, n, n, 1)
