"""Data parallelism on torch.distributed (the JAX package's
`parallel/distributed.py`; its tensor-parallel `mesh.py` has no counterpart
yet)."""

from diarizen_tpu_torch.parallel.distributed import (
    all_reduce_mean_,
    broadcast_from_host,
    gather_to_host,
    gather_window_shards,
    in_group,
    initialize_distributed,
    is_main_process,
    process_count,
    process_index,
    process_window_shard,
    reassemble_window_shards,
)

__all__ = ["all_reduce_mean_", "broadcast_from_host", "gather_to_host", "gather_window_shards",
           "in_group", "initialize_distributed", "is_main_process", "process_count",
           "process_index", "process_window_shard", "reassemble_window_shards"]
