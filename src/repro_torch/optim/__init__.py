"""Optimizers and the sparse-row gradient of the linear head."""
from repro_torch.optim.optimizers import (OptimizerConfig, OptState,
                                          apply_updates, clip_by_global_norm,
                                          global_norm, init_opt_state,
                                          schedule)
from repro_torch.optim.sparse import SparseRows, accumulate_rows

__all__ = ["OptimizerConfig", "OptState", "apply_updates",
           "clip_by_global_norm", "global_norm", "init_opt_state", "schedule",
           "SparseRows", "accumulate_rows"]
