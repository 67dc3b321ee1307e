"""Incremental generator refresh: warm-start refits and drift-triggered
subtree refits (the port of ``repro.genfit.incremental``).

A refresh during training rarely needs a new tree *structure*: the label→leaf
assignment encodes which labels are confusable and drifts slowly, while the
node parameters chase the moving feature distribution. :func:`refit_params`
keeps the previous tree's splits and re-solves only the per-node logistic
parameters, one warm-started batched Newton pass per level with no discrete
steps. :func:`refresh_tree` adds drift awareness: subtrees at ``split_depth``
whose conditional label distribution moved (total variation above
``drift_threshold``) get a full local refit, spliced into the warm tree.
Both are deterministic in (previous tree, data, config): on the card every
point sum goes through the ``segment_stats`` kernel, which adds in a fixed
order.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core.tree import Tree, padded_size
from repro_torch.core.tree_fit import FitConfig
from repro_torch.genfit.levels import (_count, _force_padding, _newton_tol, _point_tensors,
                                       _prep_data, make_newton_pieces, pack_tree,
                                       run_newton)
from repro_torch.genfit.sharded import fan_out_subtrees, splice_subtrees


class _RefitPieces:
    """Per-level pieces of a warm refit of a (C_pad, k) tree."""

    def __init__(self, c_pad: int, k: int, level: int, cfg: FitConfig, device):
        depth = c_pad.bit_length() - 1
        self.k = k
        self.shift = depth - level
        self.nseg = 1 << level
        self.newton = make_newton_pieces(self.nseg, k + 1, cfg.reg, _newton_tol(cfg), device)
        leaves = torch.arange(c_pad, device=device)
        self.side_of_leaf = ((leaves >> (self.shift - 1)) & 1).float()

    def prep(self, y, wgt, leaf_of_label, real_leaf):
        leaf_pt = leaf_of_label[y]
        seg = leaf_pt >> self.shift
        zeta = ((leaf_pt >> (self.shift - 1)) & 1).float() * 2.0 - 1.0
        realf = real_leaf.float()
        # The leaves of a node are contiguous: per-node sums are view sums.
        right_real = (realf * self.side_of_leaf).reshape(self.nseg, -1).sum(1)
        left_real = (realf * (1.0 - self.side_of_leaf)).reshape(self.nseg, -1).sum(1)
        npts = _count(seg, wgt > 0, self.nseg)
        # Padding-forced nodes keep their forced decision; nodes with no
        # data keep their previous parameters.
        frozen = (right_real == 0) | (left_real == 0) | (npts == 0)
        return dict(seg=seg, zeta=zeta, frozen=frozen, right_real=right_real,
                    left_real=left_real, has_real=(right_real + left_real) > 0)


def real_leaf_mask(tree: Tree, num_labels: int) -> np.ndarray:
    """(C_pad,) bool: which leaves hold a real label (padding leaves alias
    label 0 but fail the round trip)."""
    l2l = tree.leaf_to_label.cpu().numpy()
    return tree.label_to_leaf.cpu().numpy()[l2l] == np.arange(len(l2l))


def perm_from_tree(tree: Tree, num_labels: int) -> np.ndarray:
    """The slot permutation (perm[leaf] = label id, distinct padding ids
    ≥ num_labels on padding leaves)."""
    real = real_leaf_mask(tree, num_labels)
    perm = np.where(real, tree.leaf_to_label.cpu().numpy(), -1)
    perm[~real] = num_labels + np.arange(int((~real).sum()))
    return perm


def refit_params(tree: Tree, features, labels, num_labels: int, sample_weight=None,
                 config: Optional[FitConfig] = None, device="cuda") -> Tree:
    """Warm-start refit: keep the tree structure, re-solve (w, b).

    One batched Newton pass per level, warm-started from the previous
    parameters: O(log C) phases with no discrete steps. Nodes without data
    keep their previous parameters; padding forcing is re-derived from the
    unchanged leaf occupancy. The tree's tensors are created on ``device``.
    """
    dev = device_lib.resolve(device)
    cfg = config or FitConfig()
    x, y, wgt = _prep_data(features, labels, num_labels, sample_weight)
    depth = tree.depth
    c_pad = 1 << depth
    k = x.shape[1]
    if c_pad < padded_size(num_labels) or k != tree.feature_dim:
        raise ValueError(f"tree of depth {depth} and k={tree.feature_dim} cannot hold "
                         f"{num_labels} labels of k={k} features")
    xb, outer, yj, wj = _point_tensors(x, y, wgt, dev)
    l2l = tree.label_to_leaf.to(dev)
    real_leaf = torch.from_numpy(real_leaf_mask(tree, num_labels)).to(dev)

    w_prev, b_prev = tree.w.cpu().numpy(), tree.b.cpu().numpy()
    w_all, b_all = w_prev.copy(), b_prev.copy()
    for level in range(depth):
        pieces = _RefitPieces(c_pad, k, level, cfg, dev)
        aux = pieces.prep(yj, wj, l2l, real_leaf)
        n_lvl = 1 << level
        lo = n_lvl - 1
        theta = torch.from_numpy(np.concatenate(
            [w_prev[lo:lo + n_lvl], b_prev[lo:lo + n_lvl, None]], axis=-1)).to(dev)
        theta = run_newton(pieces.newton, theta, aux["frozen"], xb, outer, aux["zeta"],
                           wj, aux["seg"], aux["seg"].cpu().numpy(), cfg.max_newton)
        th = _force_padding(theta, aux["right_real"], aux["left_real"], aux["has_real"],
                            k).cpu().numpy()
        w_all[lo:lo + n_lvl] = th[:, :k]
        b_all[lo:lo + n_lvl] = th[:, k]
    return Tree(w=torch.from_numpy(w_all).to(dev), b=torch.from_numpy(b_all).to(dev),
                label_to_leaf=tree.label_to_leaf.to(dev),
                leaf_to_label=tree.leaf_to_label.to(dev))


def label_counts(labels, num_labels: int, sample_weight=None) -> np.ndarray:
    y = np.asarray(labels).reshape(-1)
    w = (None if sample_weight is None
         else np.asarray(sample_weight, np.float64).reshape(-1))
    return np.bincount(y, weights=w, minlength=num_labels).astype(np.float64)


def subtree_drift(prev_counts: np.ndarray, counts: np.ndarray, tree: Tree,
                  split_depth: int) -> np.ndarray:
    """Total-variation distance between the *conditional* label
    distributions of each depth-``split_depth`` subtree, previous fit against
    now. Empty-then and empty-now subtrees drift 0; newly populated ones
    drift 1 (they were never fitted on data)."""
    depth = tree.depth
    split_depth = max(0, min(split_depth, depth))
    sub = tree.label_to_leaf.cpu().numpy() >> (depth - split_depth)
    drifts = np.zeros((1 << split_depth,))
    for j in range(len(drifts)):
        sel = sub == j
        a, b = prev_counts[sel], counts[sel]
        sa, sb = a.sum(), b.sum()
        if sa == 0 and sb == 0:
            continue
        if sa == 0 or sb == 0:
            drifts[j] = 1.0
            continue
        drifts[j] = 0.5 * np.abs(a / sa - b / sb).sum()
    return drifts


def refresh_tree(prev_tree: Tree, features, labels, num_labels: int,
                 sample_weight=None, config: Optional[FitConfig] = None,
                 prev_counts: Optional[np.ndarray] = None,
                 drift_threshold: Optional[float] = None, split_depth: int = 3,
                 executor=None, device="cuda") -> Tuple[Tree, np.ndarray]:
    """Incremental refresh: warm parameter refit everywhere, plus full
    subtree-local refits where the label distribution drifted.

    Returns ``(tree, counts)``; feed ``counts`` back as ``prev_counts`` at
    the next refresh. With ``drift_threshold=None`` (or no ``prev_counts``)
    this is a pure parameter refit. Deterministic in its inputs.
    """
    cfg = config or FitConfig()
    tree = refit_params(prev_tree, features, labels, num_labels,
                        sample_weight=sample_weight, config=cfg, device=device)
    counts = label_counts(labels, num_labels, sample_weight)
    if drift_threshold is None or prev_counts is None:
        return tree, counts
    depth = tree.depth
    c_pad = 1 << depth
    split_depth = max(1, min(split_depth, depth))
    drifts = subtree_drift(prev_counts, counts, tree, split_depth)
    drifted = [int(j) for j in np.nonzero(drifts > drift_threshold)[0]]
    if not drifted:
        return tree, counts
    x, y, wgt = _prep_data(features, labels, num_labels, sample_weight)
    perm = perm_from_tree(tree, num_labels)
    slot_of_label = np.zeros((c_pad,), np.int64)
    slot_of_label[perm] = np.arange(c_pad)
    results = fan_out_subtrees(x, y, wgt, perm, slot_of_label, num_labels, c_pad,
                               split_depth, drifted, cfg, executor=executor,
                               device=device)
    w_all, b_all, perm = splice_subtrees(tree.w.cpu().numpy().copy(),
                                         tree.b.cpu().numpy().copy(), perm, results,
                                         split_depth, c_pad, num_labels)
    return pack_tree(w_all, b_all, perm, num_labels, tree.w.device), counts
