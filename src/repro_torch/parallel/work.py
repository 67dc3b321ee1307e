"""Round-robin division of independent fit tasks between processes.

The generator fit's subtrees (:mod:`repro_torch.genfit.sharded`) are
independent problems with small results, so fitting on several hosts is plain
round-robin work division plus one merge of disjoint node rows by the caller.
``shard_index``/``shard_count`` default to this process's rank and world size
in ``torch.distributed`` when a process group is initialised, else to shard 0
of 1.
"""
from __future__ import annotations

from typing import List, Optional

import torch


def round_robin_shard(n_items: int, shard_index: Optional[int] = None,
                      shard_count: Optional[int] = None) -> List[int]:
    """Item ids owned by this shard: ``[i for i in range(n) if i % count ==
    index]``."""
    dist = torch.distributed
    grouped = dist.is_available() and dist.is_initialized()
    if shard_index is None:
        shard_index = dist.get_rank() if grouped else 0
    if shard_count is None:
        shard_count = dist.get_world_size() if grouped else 1
    if not 0 <= shard_index < shard_count:
        raise ValueError(f"shard_index must be in [0, {shard_count}), got {shard_index}")
    return [i for i in range(n_items) if i % shard_count == shard_index]
