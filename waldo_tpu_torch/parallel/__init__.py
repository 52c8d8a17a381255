"""Data parallelism over processes (counterpart of waldo_tpu/parallel/)."""
from .mesh import (TIMEOUT_S, BatchShard, RowStream, all_gather, all_reduce_mean, backend,
                   barrier, broadcast_object, broadcast_tensors_, distributed, init_distributed,
                   is_main, local_device, mean_over_ranks, rank, setup, world_size)
