"""Data parallelism and sequence sharding over processes (counterpart of
waldo_tpu/parallel/)."""
from .mesh import (TIMEOUT_S, BatchShard, Grid, RowStream, all_gather, all_reduce_mean, backend,
                   barrier, broadcast_object, broadcast_tensors_, data_group, data_rank,
                   data_world, distributed, grid, grid_coordinates, init_distributed, init_grid,
                   is_main, local_device, mean_over_ranks, rank, reset_grid, rows_writer,
                   seq_group, seq_rank, seq_world, setup, world_size)
from .sharding import TokenShard, gather_tokens, shard_batch_only, shard_tokens, token_shard
