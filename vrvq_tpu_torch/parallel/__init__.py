"""Training and serving over several cards (counterpart of
``vrvq_tpu/parallel``)."""

from .dist import (all_reduce_mean_, barrier, broadcast_object, broadcast_params_,
                   data_world_size, init_distributed, layout, local_batch_size,
                   local_rows, mean_over_ranks, rank, spawn, world, zero_optimizer)

__all__ = ["all_reduce_mean_", "barrier", "broadcast_object", "broadcast_params_",
           "data_world_size", "init_distributed", "layout", "local_batch_size",
           "local_rows", "mean_over_ranks", "rank", "spawn", "world",
           "zero_optimizer"]
