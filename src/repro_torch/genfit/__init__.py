"""repro_torch.genfit: generator fitting at scale (the port of ``repro.genfit``).

Level-parallel batched fitting in O(log C) sequential phases
(:mod:`~repro_torch.genfit.levels`), warm-start and drift-triggered
refreshes (:mod:`~repro_torch.genfit.incremental`), and subtree-sharded
fan-out (:mod:`~repro_torch.genfit.sharded`). Every floating-point sum over
points goes through ``ops.segment_stats``, the hand-written CUDA kernel on
the card. :func:`repro_torch.core.tree_fit.fit_tree` stays the sequential
oracle they are held against.
"""
from repro_torch.genfit.incremental import (label_counts, refit_params, refresh_tree,
                                            subtree_drift)
from repro_torch.genfit.levels import fit_tree_levelwise
from repro_torch.genfit.sharded import fit_tree_sharded

__all__ = ["fit_tree_levelwise", "fit_tree_sharded", "label_counts", "refit_params",
           "refresh_tree", "subtree_drift"]
