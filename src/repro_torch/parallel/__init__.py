"""Work division and the model on a ``("data", "model")`` process mesh over
``torch.distributed``: placement (:mod:`repro_torch.parallel.sharding`),
collectives (:mod:`repro_torch.parallel.collectives`) and activation hints
(:mod:`repro_torch.parallel.hints`)."""
from repro_torch.parallel.sharding import (batch_slice, check_mesh, gather_head,
                                           gather_rows, gather_train_state,
                                           iter_gathered_leaves, mesh_axes, row_range,
                                           shard_batch, shard_head, shard_rows,
                                           shard_train_state, train_state_spec)
from repro_torch.parallel.work import merge_disjoint, round_robin_shard

__all__ = ["batch_slice", "check_mesh", "gather_head", "gather_rows", "gather_train_state",
           "iter_gathered_leaves", "merge_disjoint", "mesh_axes", "round_robin_shard",
           "row_range", "shard_batch", "shard_head", "shard_rows", "shard_train_state",
           "train_state_spec"]
