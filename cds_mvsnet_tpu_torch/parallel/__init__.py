"""Data parallelism over ``torch.distributed``: the process group, the ranks'
devices and batch slices, the weights broadcast from rank 0, and eval
sharded over the reference views."""

from .distributed import initialize_distributed, process_local_batch_slice
from .eval_sharding import make_sharded_eval, pad_to_multiple
from .mesh import batch_sharding, data_mesh, replicate, shard_batch

__all__ = ["batch_sharding", "data_mesh", "initialize_distributed", "make_sharded_eval",
           "pad_to_multiple", "process_local_batch_slice", "replicate", "shard_batch"]
