"""Host-level work division for the port (``torch.distributed`` coordinates)."""
from repro_torch.parallel.work import round_robin_shard

__all__ = ["round_robin_shard"]
