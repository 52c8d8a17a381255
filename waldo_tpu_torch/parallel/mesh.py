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

The process grid (``init_grid``, from ``cfg.mesh_shape`` / ``cfg.mesh_axes``
as the JAX package's ``make_mesh`` lays devices out): ranks are
``np.arange(W).reshape(mesh_shape)``, so on ("data", "seq") rank = d S + s.
The batch splits over the first axis alone, as the JAX package's
``shard_batch`` splits it: the loader's rows, ``BatchShard``, ``RowStream``,
``all_gather`` and the means work over the rank's data coordinate and its
data line (the ranks that differ from it on the data axis only). The
ranks that share a data coordinate (on ("data", "seq"), a seq line) hold
the same rows and make the same draws; a "seq" axis splits the token axis
of the attention stacks among them (parallel/sharding.py). Without a grid
(``init_grid`` not called) every rank lies on the data axis.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import check_mesh, check_mesh_shape

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


@dataclass(frozen=True)
class Grid:
    """This rank's place on the process grid: its data and seq coordinates
    and the sizes of those axes, and the process groups of its data line
    and its seq line (the ranks that differ from it on that axis only; None
    where the line is the whole world or one rank)."""

    data_rank: int = 0
    data_world: int = 1
    seq_rank: int = 0
    seq_world: int = 1
    data_group: Optional[object] = None
    seq_group: Optional[object] = None


_GRID: Optional[Grid] = None


def _line_group(ids: np.ndarray, axis: int, r: int):
    """Every line of ``ids`` along ``axis`` made a process group, in one
    order on every rank (``dist.new_group`` is collective); returns the
    group of the line that holds rank ``r``."""
    lines = np.moveaxis(ids, axis, -1).reshape(-1, ids.shape[axis])
    mine = None
    for line in lines:
        group = dist.new_group([int(i) for i in line])
        if r in line:
            mine = group
    return mine


def grid_coordinates(mesh_shape: Optional[Sequence[int]], mesh_axes: Sequence[str], world: int,
                     r: int) -> Tuple[int, int, int, int]:
    """Rank ``r``'s (data rank, data world, seq rank, seq world) on the grid
    of ``mesh_shape`` over ``mesh_axes`` at ``world`` ranks
    (config.check_mesh_shape's rules): rank r sits at
    ``np.unravel_index(r, shape)``, the JAX package's device order."""
    axes = list(mesh_axes)
    shape = check_mesh_shape(mesh_shape, axes, world)
    coords = np.unravel_index(r, shape)
    if "seq" not in axes:
        return int(coords[0]), shape[0], 0, 1
    s = axes.index("seq")
    return int(coords[0]), shape[0], int(coords[s]), shape[s]


def init_grid(mesh_shape: Optional[Sequence[int]], mesh_axes: Sequence[str]) -> Grid:
    """The grid of ``mesh_shape`` over ``mesh_axes`` at the process group's
    world size (``grid_coordinates``), its data and seq lines made process
    groups; every rank calls it, once, after ``init_distributed``. Returns
    this rank's ``Grid``."""
    global _GRID
    axes, w = list(mesh_axes), world_size()
    shape = check_mesh_shape(mesh_shape, axes, w)
    d_rank, d_world, s_rank, s_world = grid_coordinates(shape, axes, w, rank())
    ids = np.arange(w).reshape(shape)
    data_group = seq_group = None
    if d_world not in (1, w):
        data_group = _line_group(ids, 0, rank())
    if s_world > 1:
        seq_group = _line_group(ids, axes.index("seq"), rank())
    _GRID = Grid(d_rank, d_world, s_rank, s_world, data_group, seq_group)
    return _GRID


def reset_grid() -> None:
    """Forgets the grid (every rank on the data axis again), as before
    ``init_grid``; for a process whose group is destroyed."""
    global _GRID
    _GRID = None


def grid() -> Grid:
    """This rank's grid: ``init_grid``'s, else every rank on the data axis."""
    if _GRID is not None and distributed():
        return _GRID
    return Grid(data_rank=rank(), data_world=world_size())


def data_rank() -> int:
    """This rank's coordinate on the grid's first (data) axis."""
    return grid().data_rank


def data_world() -> int:
    """The size of the data axis: the number of parts of the batch."""
    return grid().data_world


def seq_rank() -> int:
    """This rank's coordinate on the "seq" axis (0 without one)."""
    return grid().seq_rank


def seq_world() -> int:
    """The size of the "seq" axis (1 without one)."""
    return grid().seq_world


def data_group():
    """The process group of this rank's data line (None: the whole world)."""
    return grid().data_group


def seq_group():
    """The process group of this rank's seq line (None without a seq axis)."""
    return grid().seq_group


def rows_writer() -> bool:
    """Whether this rank is the first of those that share its data
    coordinate (every other coordinate 0): the one that writes their rows'
    files."""
    g = grid()
    return rank() == data_rank() * (world_size() // g.data_world)


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
    reset_grid()
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def setup(cfg, device="cuda") -> torch.device:
    """A run's start on every rank (the trainer's and the evaluator's): the
    config's mesh checked against the launcher's world size, the process
    group and the grid's groups up under torchrun, rank 0's
    ``cfg.datetime`` (which names the run's directories) on every rank.
    Returns this process's device."""
    check_mesh(cfg, world_size() if distributed() else int(os.environ.get("WORLD_SIZE", "1")))
    if init_distributed(device):
        init_grid(cfg.mesh_shape, cfg.mesh_axes)
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
    """The mean of ``x`` over the rank's data line (a new tensor): the
    ranks that share a data coordinate hold equal values."""
    if data_world() == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, group=data_group())
    return y / data_world()


def mean_over_ranks(values: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """Each 0-d entry of ``values`` (tensors or floats) averaged over the
    data line in one all-reduce, as float32 tensors on ``device``; every
    rank must hand over the same keys."""
    if data_world() == 1 or not values:
        return values
    keys = sorted(values)
    vec = torch.stack([torch.as_tensor(values[k], device=device).float().reshape(())
                       for k in keys])
    return dict(zip(keys, all_reduce_mean(vec).unbind()))


class _AllGather(torch.autograd.Function):
    """The equal-sized ``x`` of a group's ranks concatenated along ``dim``,
    in group-rank order. Both directions are one all-reduce over the group,
    which gloo runs on CUDA tensors too: the forward sums buffers that hold
    each rank's part and zeros elsewhere (exact), the backward sums the
    ranks' gradients and keeps the rank's part, so every rank's use of the
    gathered tensor reaches the part's owner."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n, r = x.shape[dim], dist.get_rank(group)
        ctx.dim, ctx.group, ctx.start, ctx.n = dim, group, r * n, n
        shape = list(x.shape)
        shape[dim] = dist.get_world_size(group) * n
        out = x.new_zeros(shape)
        out.narrow(dim, r * n, n).copy_(x)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None


def all_gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """Every rank's ``x`` of a group (equal shapes; the data line by
    default) concatenated along ``dim`` in rank order, differentiable;
    ``x`` itself where the group is one rank."""
    if group is None:
        if data_world() == 1:
            return x
        group = data_group()
    if group is None:  # the data line is the whole world
        group = dist.group.WORLD
    return _AllGather.apply(x, dim, group)


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
        """This rank's rows when every rank holds ``local_size`` of them: the
        rows of its data coordinate among the data axis's parts."""
        w = data_world()
        return cls(data_rank() * local_size, local_size, w * local_size, w)

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

