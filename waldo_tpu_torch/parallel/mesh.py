"""Data parallelism over processes (counterpart of waldo_tpu/parallel/mesh.py),
as ``torch.distributed``.

One process per card, launched by torchrun; NCCL on cards, gloo on the CPU:

  python -m torch.distributed.run --standalone --nproc_per_node N \\
      -m waldo_tpu_torch.cli.train <a training script's flags>

The numerical contract: a run at world size W gives the batches, random
draws, losses, gradients and parameters of world size 1 on the same global
batch, to summation order, as the JAX package's one-program data
parallelism does:
  - the loader hands rank r rows [r B/W, (r+1) B/W) of each global batch of
    B clips, made from world 1's draws (data/loader.py);
  - a loss draws its random numbers at the global batch's shape from a
    generator seeded alike on every rank and keeps the rank's rows
    (``RowStream``), and sees the whole batch where a term couples its
    clips (``BatchShard.gather``, an all-gather with a gradient);
  - the step sums the ranks' gradients and non-finite flags in one
    all-reduce and skips on every rank when any rank's loss is not finite
    (train/train_state.py).
Where no process group is up (no ``WORLD_SIZE`` in the environment), every
function here is world 1's identity.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import check_mesh

TIMEOUT_S = 300  # the reference's process-group timeout


def distributed() -> bool:
    """Whether a process group is up."""
    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The process group's backend ("nccl", "gloo"), None without one."""
    return dist.get_backend() if distributed() else None


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def is_main() -> bool:
    """Rank 0, the process that logs, prints and saves."""
    return rank() == 0


def local_device(device) -> torch.device:
    """``device``, or this process's card ``cuda:LOCAL_RANK`` where
    ``device`` names the card type without an index under torchrun."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def init_distributed(device="cuda", backend: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S, init_method: str = "env://") -> bool:
    """Brings up the process group when torchrun's ``WORLD_SIZE`` is set, at
    world 1 too: NCCL for ``cuda``, gloo for ``cpu``, or ``backend``.
    Returns whether a process group is up; a no-op without ``WORLD_SIZE``
    and once the group is up."""
    if distributed():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def setup(cfg, device="cuda") -> torch.device:
    """A run's start on every rank (the trainer's and the evaluator's): the
    config's mesh checked, the process group up under torchrun, rank 0's
    ``cfg.datetime`` (which names the run's directories) on every rank.
    Returns this process's device."""
    check_mesh(cfg)
    init_distributed(device)
    cfg.datetime = broadcast_object(cfg.datetime)
    return local_device(device)


def barrier() -> None:
    if distributed():
        dist.barrier()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (any picklable object) on every rank."""
    if not distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


@torch.no_grad()
def broadcast_tensors_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrites ``tensors`` (of one dtype and device) with rank ``src``'s,
    in one broadcast."""
    if not distributed() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=src)
    for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(v.view_as(t))


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (a new tensor)."""
    if not distributed():
        return x
    y = x.clone()
    dist.all_reduce(y)
    return y / world_size()


def mean_over_ranks(values: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """Each 0-d entry of ``values`` (tensors or floats) averaged over the
    ranks in one all-reduce, as float32 tensors on ``device``; every rank
    must hand over the same keys."""
    if not distributed() or not values:
        return values
    keys = sorted(values)
    vec = torch.stack([torch.as_tensor(values[k], device=device).float().reshape(())
                       for k in keys])
    return dict(zip(keys, all_reduce_mean(vec).unbind()))


class _AllGather(torch.autograd.Function):
    """The ranks' equal-sized ``x`` stacked along dim 0, in rank order. Both
    directions are one all-reduce, which gloo runs on CUDA tensors too: the
    forward sums buffers that hold each rank's rows and zeros elsewhere
    (exact), the backward sums the ranks' gradients and keeps the rank's
    rows, so every rank's use of the gathered tensor reaches the rows'
    owner."""

    @staticmethod
    def forward(ctx, x):
        n, r = x.shape[0], rank()
        ctx.rows = slice(r * n, (r + 1) * n)
        out = x.new_zeros((world_size() * n,) + tuple(x.shape[1:]))
        out[ctx.rows] = x
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g[ctx.rows]


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, differentiable; ``x`` itself without a process group."""
    return _AllGather.apply(x) if distributed() else x


@dataclass(frozen=True)
class BatchShard:
    """The rows [offset, offset + size) of a global batch of ``total`` rows
    that one of ``world`` ranks holds."""

    offset: int
    size: int
    total: int
    world: int = 1

    @classmethod
    def whole(cls, b: int) -> "BatchShard":
        return cls(0, b, b, 1)

    @classmethod
    def of_rank(cls, local_size: int) -> "BatchShard":
        """This rank's rows when every rank holds ``local_size`` of them."""
        w = world_size()
        return cls(rank() * local_size, local_size, w * local_size, w)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a tensor over the global batch."""
        if self.size == self.total:
            return x
        return x[self.offset:self.offset + self.size]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch of a tensor over the rank's rows, differentiable."""
        return all_gather(x) if self.world > 1 else x


@dataclass(frozen=True)
class RowStream:
    """A random stream that the ranks share: each draw is made at the global
    batch's shape from ``generator`` (seeded alike on every rank; None is
    torch's default generator), and the rank keeps its rows. ``shape``'s
    leading dim is the rank's rows."""

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
        """The global batch's draw itself (every rank's rows)."""
        return torch.randint(low, high, self._global(shape), generator=self.generator,
                             device=device)

