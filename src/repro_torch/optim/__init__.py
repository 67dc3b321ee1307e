"""Optimizers, compressed optimizer state and the sparse-row gradient of the
linear head."""
from repro_torch.optim.compression import (EFState, QuantizedRows,
                                           compress_with_error_feedback,
                                           decompress, dequantize_rows,
                                           init_ef_state, load_rows,
                                           quantize_rows, store_rows)
from repro_torch.optim.optimizers import (OptimizerConfig, OptState, Sm3Cover,
                                          apply_updates, clip_by_global_norm,
                                          global_norm, head_state_bytes,
                                          init_opt_state, schedule, tree_nbytes)
from repro_torch.optim.sparse import SparseRows, accumulate_embed_rows, accumulate_rows

__all__ = ["EFState", "QuantizedRows", "compress_with_error_feedback",
           "decompress", "dequantize_rows", "init_ef_state", "load_rows",
           "quantize_rows", "store_rows", "OptimizerConfig", "OptState",
           "Sm3Cover", "apply_updates", "clip_by_global_norm", "global_norm",
           "head_state_bytes", "init_opt_state", "schedule", "tree_nbytes",
           "SparseRows", "accumulate_embed_rows", "accumulate_rows"]
