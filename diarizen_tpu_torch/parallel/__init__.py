"""Data and tensor parallelism on torch.distributed (the JAX package's
`parallel/distributed.py` and `parallel/mesh.py`)."""

from diarizen_tpu_torch.parallel.distributed import (
    all_reduce_mean_,
    all_reduce_sum,
    broadcast_from_host,
    copy_to_group,
    gather_to_host,
    gather_window_shards,
    in_group,
    initialize_distributed,
    is_main_process,
    process_count,
    process_index,
    process_window_shard,
    reassemble_window_shards,
    reduce_from_group,
)
from diarizen_tpu_torch.parallel.mesh import (
    Mesh,
    data_sharding,
    eend_param_shardings,
    gather_state,
    gather_state_dict,
    local_state,
    make_mesh,
    model_mesh,
    replicated,
    shard_batch,
    shard_model_,
)

__all__ = ["Mesh", "all_reduce_mean_", "all_reduce_sum", "broadcast_from_host", "copy_to_group",
           "data_sharding", "eend_param_shardings", "gather_state",
           "gather_state_dict", "gather_to_host", "gather_window_shards", "in_group",
           "initialize_distributed", "is_main_process", "local_state", "make_mesh", "model_mesh",
           "process_count", "process_index", "process_window_shard",
           "reassemble_window_shards", "reduce_from_group", "replicated", "shard_batch",
           "shard_model_"]
