"""Greedy fitting of the adversarial generator tree (paper §3).

Maximizes the tree log-likelihood (Eq. 7) over (a) per-node logistic
parameters (w_nu, b_nu) and (b) the label→leaf assignment, by recursively
splitting the label set into equal halves:

  * continuous step — Newton ascent on the convex per-node objective
    L_nu (Eq. 8), hyperparameter-free (paper: "converges quickly to machine
    precision with Newton ascent");
  * discrete step — re-partition Y_nu by the score Delta_y (Eq. 9): the half
    of labels with the largest ``sum_{x in D_y} (w^T x + b)`` goes right.

The two steps alternate until the partition is stable (a local optimum),
then recurse into the children. Runs offline in float64 numpy, the same
arithmetic as ``repro.core.tree_fit``; the result is packed into the port's
:class:`~repro_torch.core.tree.Tree` (float32 tables, int64 label maps) on
``device``. This per-node recursion is the reference oracle, O(C)
sequential phases; the level-synchronous fitter at scale comes with the
generator-fitting slice.

Supports per-example ``sample_weight`` so aggregated data fits without
expansion.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core.tree import PAD_LOGIT, Tree, log_prob, padded_size


@dataclasses.dataclass
class FitConfig:
    reg: float = 0.1              # lambda_n, quadratic regularizer (paper §3)
    max_alternations: int = 8     # discrete/continuous alternations per node
    max_newton: int = 25
    newton_tol: float = 1e-8
    seed: int = 0


def _log_sigmoid(z: np.ndarray) -> np.ndarray:
    return -np.logaddexp(0.0, -z)


def _newton_logistic(x: np.ndarray, zeta: np.ndarray, wgt: np.ndarray,
                     w: np.ndarray, b: float, cfg: FitConfig):
    """Damped Newton ascent on L_nu (Eq. 8) with ridge -reg*(|w|^2 + b^2).

    x: (n, k); zeta: (n,) in {-1, +1}; wgt: (n,) nonneg. The objective is
    concave; Armijo backtracking guarantees monotone ascent (plain Newton
    oscillates on separable data where the sigmoids saturate).
    """
    k = x.shape[1]
    xb = np.concatenate([x, np.ones((x.shape[0], 1))], axis=1)   # (n, k+1)
    theta = np.concatenate([w, [b]])
    eye = np.eye(k + 1)

    def objective(th):
        z = zeta * (xb @ th)
        return float(np.dot(wgt, _log_sigmoid(z)) - cfg.reg * np.dot(th, th))

    obj = objective(theta)
    for _ in range(cfg.max_newton):
        z = xb @ theta                                           # (n,)
        s = 1.0 / (1.0 + np.exp(-np.clip(zeta * z, -60, 60)))    # sigma(zeta z)
        grad = xb.T @ (wgt * zeta * (1.0 - s)) - 2.0 * cfg.reg * theta
        h_diag = wgt * s * (1.0 - s)                             # (n,)
        hess_neg = (xb.T * h_diag) @ xb + 2.0 * cfg.reg * eye    # -H, pos.def.
        try:
            direction = np.linalg.solve(hess_neg, grad)          # ascent dir
        except np.linalg.LinAlgError:
            direction = np.linalg.lstsq(hess_neg, grad, rcond=None)[0]
        slope = float(grad @ direction)
        if not np.isfinite(slope) or slope <= 0:
            break
        t = 1.0
        for _ls in range(40):
            cand = theta + t * direction
            obj_cand = objective(cand)
            if obj_cand >= obj + 1e-4 * t * slope:
                break
            t *= 0.5
        else:
            break
        theta, obj = cand, obj_cand
        if float(np.abs(t * direction).max()) < cfg.newton_tol:
            break
    return theta[:k], float(theta[k])


def _init_w(x: np.ndarray, y_local: np.ndarray, wgt: np.ndarray,
            n_labels: int, rng: np.random.Generator) -> np.ndarray:
    """Paper init: dominant eigenvector of the covariance of the per-label
    feature-sum vectors {sum_{x in D_y} x}_y. Power iteration, 20 steps."""
    k = x.shape[1]
    sums = np.zeros((n_labels, k))
    np.add.at(sums, y_local, x * wgt[:, None])
    sums = sums - sums.mean(axis=0, keepdims=True)
    v = rng.standard_normal(k)
    v /= np.linalg.norm(v) + 1e-12
    for _ in range(20):
        v = sums.T @ (sums @ v)
        nrm = np.linalg.norm(v)
        if nrm < 1e-12:
            return rng.standard_normal(k) * 0.01
        v /= nrm
    return v


def _local_labels(lab: np.ndarray, y_pts: np.ndarray) -> np.ndarray:
    """Position of each point's label within the node's label subset."""
    lab_pos = {int(l): i for i, l in enumerate(lab)}
    return np.fromiter((lab_pos[int(v)] for v in y_pts), np.int64,
                       count=len(y_pts))


def fit_tree(features: np.ndarray, labels: np.ndarray, num_labels: int,
             sample_weight: Optional[np.ndarray] = None,
             config: Optional[FitConfig] = None, device="cuda") -> Tree:
    """Fit the generator tree on (features, labels); the tree's tensors are
    created on ``device``.

    features: (N, k) — already projected to the reduced dim k (see
      :func:`pca_projection`); labels: (N,) int in [0, num_labels).
    """
    dev = device_lib.resolve(device)
    cfg = config or FitConfig()
    rng = np.random.default_rng(cfg.seed)
    x = np.asarray(features, np.float64)
    y = np.asarray(labels, np.int64)
    wgt = (np.ones(len(y)) if sample_weight is None
           else np.asarray(sample_weight, np.float64))
    if x.ndim != 2 or y.shape != (x.shape[0],):
        raise ValueError(f"fit_tree: features must be (N, k) and labels (N,), "
                         f"got {x.shape} and {y.shape}")

    c_pad = padded_size(num_labels)
    depth = c_pad.bit_length() - 1
    n_nodes = c_pad - 1
    k = x.shape[1]
    w_all = np.zeros((n_nodes, k))
    b_all = np.zeros((n_nodes,))
    label_to_leaf = np.zeros((num_labels,), np.int64)

    # Recursion stack: (node_index, label_subset, point_index_subset).
    # label_subset entries >= num_labels are padding labels (no data).
    stack = [(0, np.arange(c_pad), np.argsort(y, kind="stable"))]
    while stack:
        node, lab, pts = stack.pop()
        n_lab = len(lab)
        half = n_lab // 2
        is_pad = lab >= num_labels
        n_real = int((~is_pad).sum())

        if n_real == 0:
            zeta_split = np.zeros(n_lab, bool)
            zeta_split[half:] = True      # arbitrary; subtree has zero mass
            b_all[node] = -PAD_LOGIT
        elif len(pts) == 0:
            # Labels never observed: keep natural order, no parameters.
            zeta_split = np.zeros(n_lab, bool)
            zeta_split[half:] = True
        else:
            xs, ws_ = x[pts], wgt[pts]
            y_local = _local_labels(lab, y[pts])
            w_nu = _init_w(xs, y_local, ws_, n_lab, rng)
            b_nu = 0.0
            zeta_split = np.zeros(n_lab, bool)   # True -> right child
            for _ in range(cfg.max_alternations):
                # Discrete step (Eq. 9): Delta_y = sum_{x in D_y} (w.x + b).
                z = xs @ w_nu + b_nu
                delta = np.zeros(n_lab)
                np.add.at(delta, y_local, ws_ * z)
                delta[is_pad] = -np.inf          # padding sinks to the left...
                # ...unless the right half must absorb padding (only happens
                # when n_real < half): then padding fills from the right end.
                order = np.argsort(-delta, kind="stable")
                new_split = np.zeros(n_lab, bool)
                new_split[order[:half]] = True
                if n_real <= half:
                    # All real labels fit in the right half; pack padding left.
                    new_split[:] = False
                    new_split[np.nonzero(~is_pad)[0]] = True
                    n_fill = half - n_real
                    pad_idx = np.nonzero(is_pad)[0]
                    new_split[pad_idx[:n_fill]] = True
                if np.array_equal(new_split, zeta_split):
                    break
                zeta_split = new_split
                # Continuous step: Newton ascent with the new partition.
                zeta_pts = np.where(zeta_split[y_local], 1.0, -1.0)
                w_nu, b_nu = _newton_logistic(xs, zeta_pts, ws_, w_nu, b_nu,
                                              cfg)
            w_all[node], b_all[node] = w_nu, b_nu
            # Force decisions away from padding-only children (paper §3).
            if int((~is_pad & zeta_split).sum()) == 0:
                w_all[node], b_all[node] = 0.0, -PAD_LOGIT
            if int((~is_pad & ~zeta_split).sum()) == 0:
                w_all[node], b_all[node] = 0.0, PAD_LOGIT

        left_lab, right_lab = lab[~zeta_split], lab[zeta_split]
        # `lab` is not sorted after re-splits; route points via positions.
        go_right = (zeta_split[_local_labels(lab, y[pts])] if len(pts)
                    else np.zeros(0, bool))
        left_pts, right_pts = pts[~go_right], pts[go_right]

        level = (node + 1).bit_length() - 1
        if level + 1 == depth:                      # children are leaves
            leaf_base = 2 * node + 2 - (1 << depth)  # leaf idx of left child
            for leaf_off, l in ((0, left_lab), (1, right_lab)):
                if int(l[0]) < num_labels:
                    label_to_leaf[int(l[0])] = leaf_base + leaf_off
        else:
            stack.append((2 * node + 1, left_lab, left_pts))
            stack.append((2 * node + 2, right_lab, right_pts))

    leaf_to_label = np.zeros((c_pad,), np.int64)
    leaf_to_label[label_to_leaf] = np.arange(num_labels)
    return Tree(
        w=torch.from_numpy(w_all.astype(np.float32)).to(dev),
        b=torch.from_numpy(b_all.astype(np.float32)).to(dev),
        label_to_leaf=torch.from_numpy(label_to_leaf).to(dev),
        leaf_to_label=torch.from_numpy(leaf_to_label).to(dev),
    )


def pca_projection(features: np.ndarray, k: int):
    """PCA to k dims (paper §3 "Technical Details"). Returns (proj, mean):
    reduced = (x - mean) @ proj, proj: (K, k)."""
    x = np.asarray(features, np.float64)
    mean = x.mean(axis=0)
    xc = x - mean
    # Covariance eigendecomposition; K is small (<= a few thousand).
    cov = (xc.T @ xc) / max(1, len(x) - 1)
    vals, vecs = np.linalg.eigh(cov)
    proj = vecs[:, ::-1][:, :k]
    return proj.astype(np.float32), mean.astype(np.float32)


def tree_log_likelihood(tree: Tree, features, labels,
                        sample_weight: Optional[np.ndarray] = None) -> float:
    """Weighted mean log p_n(y|x) — the fitting objective (Eq. 7)/N. The
    log-probs are computed on the tree's device."""
    dev = tree.w.device
    lp = log_prob(tree, torch.as_tensor(np.asarray(features), dtype=torch.float32,
                                        device=dev),
                  torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=dev))
    w = (np.ones(len(labels)) if sample_weight is None
         else np.asarray(sample_weight))
    return float(np.average(lp.cpu().numpy(), weights=w))
