from a3t_tpu_torch.parallel.mesh import (agree, all_reduce_sum, barrier,
                                         data_rank, data_world, every,
                                         global_sum, initialize_multihost,
                                         make_mesh, model_rank, model_world,
                                         rank, rank_device, row_block, world)
from a3t_tpu_torch.parallel.sharding import (FlatLayout, all_gather_flat,
                                             all_gather_state, flat_slice,
                                             gather_state,
                                             param_partition_spec,
                                             reduce_scatter_flat, shard_flat,
                                             shard_state)
from a3t_tpu_torch.parallel.tensor import (ModelShard, copy_to_model,
                                           reduce_from_model)

__all__ = ["agree", "all_reduce_sum", "barrier", "data_rank", "data_world",
           "every", "global_sum", "initialize_multihost", "make_mesh",
           "model_rank", "model_world", "rank", "rank_device", "row_block",
           "world", "FlatLayout", "all_gather_flat", "all_gather_state",
           "flat_slice", "gather_state", "param_partition_spec",
           "reduce_scatter_flat", "shard_flat", "shard_state", "ModelShard",
           "copy_to_model", "reduce_from_model"]
