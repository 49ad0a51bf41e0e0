from a3t_tpu_torch.parallel.mesh import (agree, all_reduce_sum, barrier,
                                         data_parallel, every, global_sum,
                                         initialize_multihost, rank,
                                         rank_device, row_block, world)
from a3t_tpu_torch.parallel.sharding import (all_gather_flat, flat_slice,
                                             reduce_scatter_flat, shard_flat)

__all__ = ["agree", "all_reduce_sum", "barrier", "data_parallel",
           "every", "global_sum", "initialize_multihost", "rank", "rank_device",
           "row_block", "world", "all_gather_flat", "flat_slice",
           "reduce_scatter_flat", "shard_flat"]
