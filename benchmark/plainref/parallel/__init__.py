"""One process and whole batches: the port's ``BatchShard`` and
``RowStream`` without a process group."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class BatchShard:
    """The rows [offset, offset + size) of a batch of ``total`` rows."""

    offset: int
    size: int
    total: int
    world: int = 1

    @classmethod
    def whole(cls, b: int) -> "BatchShard":
        return cls(0, b, b, 1)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        if self.size == self.total:
            return x
        return x[self.offset:self.offset + self.size]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        if self.world > 1:
            raise ValueError("the reference runs on whole batches")
        return x


@dataclass(frozen=True)
class RowStream:
    """Draws made at the batch's shape from ``generator``."""

    generator: Optional[torch.Generator]
    shard: BatchShard

    def _global(self, shape):
        if shape[0] != self.shard.size:
            raise ValueError(f"a draw of {tuple(shape)} for a shard of {self.shard.size} rows")
        return (self.shard.total,) + tuple(shape[1:])

    def rand(self, shape, device) -> torch.Tensor:
        return self.shard.rows(torch.rand(self._global(shape), generator=self.generator,
                                          device=device))

    def randn(self, shape, device) -> torch.Tensor:
        return self.shard.rows(torch.randn(self._global(shape), generator=self.generator,
                                           device=device))

    def randint(self, low, high, shape, device) -> torch.Tensor:
        return self.shard.rows(self.randint_global(low, high, shape, device))

    def randint_global(self, low, high, shape, device) -> torch.Tensor:
        return torch.randint(low, high, self._global(shape), generator=self.generator,
                             device=device)
