"""Sharded generator fitting: independent subtrees fanned out (the port of
``repro.genfit.sharded``).

Below a split depth ``D`` the 2^D subtrees of the generator are independent
fitting problems: they share no nodes, labels or points. ``fit_tree_sharded``
runs the top ``D`` levels as one level-parallel sweep over all the data, fits
each subtree by its own :func:`~repro_torch.genfit.levels.fit_tree_levelwise`
call on its label and point subset, and splices the results into the global
node arrays.

Fan-out takes any ``concurrent.futures``-style executor, and
``shard_index``/``shard_count`` restrict a process to its round-robin share of
subtrees (:func:`repro_torch.parallel.round_robin_shard`), returning partial
``(w, b, perm)`` arrays for the caller to merge. Every subtree fit is
deterministic in its inputs, so serial and threaded fan-out give the same
bits. Subtree point sets are padded with zero-weight rows to power-of-two
buckets, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch import device as device_lib
from repro_torch.core.tree import PAD_LOGIT, padded_size
from repro_torch.core.tree_fit import FitConfig
from repro_torch.genfit.levels import _fit_levels, _prep_data, fit_tree_levelwise, pack_tree
from repro_torch.parallel import round_robin_shard

_PT_BUCKET_MIN = 1024


def _bucket_points(x, y, wgt, n_bucket: int):
    """Right-pad a subtree's point set with zero-weight rows (invisible to
    every reduction) up to ``n_bucket`` rows."""
    pad = n_bucket - len(y)
    if pad <= 0:
        return x, y, wgt
    k = x.shape[1]
    return (np.concatenate([x, np.zeros((pad, k), x.dtype)]),
            np.concatenate([y, np.zeros(pad, y.dtype)]),
            np.concatenate([wgt, np.zeros(pad, wgt.dtype)]))


def _subtree_cfg(cfg: FitConfig, j: int) -> FitConfig:
    """Deterministic per-subtree seed (independent of the fit order)."""
    return dataclasses.replace(cfg, seed=cfg.seed + 100003 * (j + 1))


def fit_one_subtree(x, y, wgt, perm, slot_of_label, num_labels: int, c_pad: int,
                    split_depth: int, j: int, cfg: FitConfig, device="cuda"):
    """Fit subtree ``j`` (leaf slots [j·S, (j+1)·S)) on its own points.

    Returns ``(w_sub, b_sub, leaf_labels)``: the subtree's S−1 node
    parameters in local level order and the global label at each of its S
    leaves (−1 for padding leaves).
    """
    s_leaves = c_pad >> split_depth
    lo = j * s_leaves
    sub_slots = perm[lo:lo + s_leaves]
    real = sub_slots[sub_slots < num_labels]
    k = x.shape[1]
    if len(real) == 0:
        # Unreachable subtree (forced away above the split): park all mass on
        # the left spine.
        return (np.zeros((s_leaves - 1, k), np.float32),
                np.full((s_leaves - 1,), -PAD_LOGIT, np.float32),
                np.full((s_leaves,), -1, np.int64))
    # Points whose label lives in this subtree, in their original order.
    pt_mask = (slot_of_label[y] >= lo) & (slot_of_label[y] < lo + s_leaves)
    local_of_global = np.full((num_labels,), -1, np.int64)
    local_of_global[real] = np.arange(len(real))
    xs, ys, ws = x[pt_mask], local_of_global[y[pt_mask]], wgt[pt_mask]
    n_bucket = _PT_BUCKET_MIN
    while n_bucket < len(ys):
        n_bucket *= 2
    xs, ys, ws = _bucket_points(xs, ys, ws, n_bucket)
    sub = fit_tree_levelwise(xs, ys, len(real), sample_weight=ws,
                             config=_subtree_cfg(cfg, j), c_pad=s_leaves, device=device)
    l2l = sub.leaf_to_label.cpu().numpy()
    occupied = sub.label_to_leaf.cpu().numpy()[l2l] == np.arange(s_leaves)
    leaf_labels = np.where(occupied, real[l2l], -1)
    return sub.w.cpu().numpy(), sub.b.cpu().numpy(), leaf_labels


def fan_out_subtrees(x, y, wgt, perm, slot_of_label, num_labels: int, c_pad: int,
                     split_depth: int, subtree_ids, cfg: FitConfig, executor=None,
                     device="cuda"):
    """Fit the given subtrees (through ``executor.map`` when given, else
    serially) and return ``[(j, w_sub, b_sub, leaf_labels), ...]`` for
    :func:`splice_subtrees`. Shared by the cold sharded fit and the
    drift-triggered refresh."""

    def fit_j(j):
        return (j, *fit_one_subtree(x, y, wgt, perm, slot_of_label, num_labels, c_pad,
                                    split_depth, j, cfg, device=device))

    mapper = executor.map if executor is not None else map
    return list(mapper(fit_j, subtree_ids))


def splice_subtrees(w_all, b_all, perm, results, split_depth: int, c_pad: int,
                    num_labels: int):
    """Write subtree fit results into the global node and permutation arrays.

    ``results``: iterable of ``(j, w_sub, b_sub, leaf_labels)``. Padding
    leaves (−1) get fresh global padding ids afterwards, so ``perm`` stays a
    permutation of [0, C_pad).
    """
    s_leaves = c_pad >> split_depth
    sub_depth = s_leaves.bit_length() - 1
    for j, w_sub, b_sub, leaf_labels in results:
        for t in range(sub_depth):
            n_t = 1 << t
            g_base = (1 << (split_depth + t)) - 1 + j * n_t
            l_base = n_t - 1
            w_all[g_base:g_base + n_t] = w_sub[l_base:l_base + n_t]
            b_all[g_base:g_base + n_t] = b_sub[l_base:l_base + n_t]
        perm[j * s_leaves:(j + 1) * s_leaves] = leaf_labels
    free = perm < 0
    used = np.zeros((c_pad,), bool)
    used[perm[~free]] = True
    perm[free] = np.nonzero(~used)[0]
    return w_all, b_all, perm


def fit_tree_sharded(features, labels, num_labels: int, sample_weight=None,
                     config: Optional[FitConfig] = None, split_depth: int = 2,
                     executor=None, shard_index: int = 0, shard_count: int = 1,
                     _return_parts: bool = False, device="cuda"):
    """Level-parallel fit with the bottom subtrees fanned out.

    The top ``split_depth`` levels are fitted on all the data; the 2^D
    subtrees are then fitted through ``executor.map`` (serially by default)
    and spliced. With ``shard_count > 1`` only this shard's round-robin share
    is fitted and the partial ``(w, b, perm)`` host arrays are returned for
    merging (rows owned by other shards stay zero); a single shard gets a
    :class:`~repro_torch.core.tree.Tree` on ``device``.
    """
    dev = device_lib.resolve(device)
    cfg = config or FitConfig()
    x, y, wgt = _prep_data(features, labels, num_labels, sample_weight)
    c_pad = padded_size(num_labels)
    depth = c_pad.bit_length() - 1
    split_depth = max(0, min(split_depth, depth))
    w_all, b_all, perm, slot = _fit_levels(x, y, wgt, num_labels, c_pad, cfg,
                                           split_depth, dev)
    if split_depth == depth:
        return pack_tree(w_all, b_all, perm, num_labels, dev)
    mine = round_robin_shard(1 << split_depth, shard_index, shard_count)
    results = fan_out_subtrees(x, y, wgt, perm, slot, num_labels, c_pad, split_depth,
                               mine, cfg, executor=executor, device=dev)
    w_all, b_all, perm = splice_subtrees(w_all, b_all, perm, results, split_depth,
                                         c_pad, num_labels)
    if _return_parts or shard_count > 1:
        return w_all, b_all, perm
    return pack_tree(w_all, b_all, perm, num_labels, dev)
