"""Hierarchically-clustered extreme-classification sets mirroring the paper's
cluster argument ("dogs vs bicycles ... Boston Terrier vs French Bulldog",
§2.2). Seeded host-side numpy, bit-equal to ``repro.data.synthetic`` for the
same spec.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusteredXCSpec:
    """Binary-tree label hierarchy: labels are leaves of a depth-D tree;
    feature = sum of per-level cluster offsets + noise. Deeper levels have
    smaller offsets, so distinguishing siblings ("Boston Terrier vs French
    Bulldog") is the hard part — exactly the regime where adversarial
    negatives beat uniform ones."""
    num_labels: int = 1024
    feature_dim: int = 64
    depth_scale: float = 0.55     # offset shrink per level
    noise: float = 0.35
    zipf_a: float = 1.3           # label frequencies ~ zipf (long tail)
    seed: int = 0


def make_clustered_xc(spec: ClusteredXCSpec, n_train: int, n_test: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """Returns (x_train, y_train, x_test, y_test): float32 features, int64
    labels."""
    rng = np.random.default_rng(spec.seed)
    c, k = spec.num_labels, spec.feature_dim
    depth = int(np.ceil(np.log2(c)))
    # Per-level offsets: node at level l contributes scale^l * offset.
    centers = np.zeros((c, k), np.float64)
    for level in range(depth):
        n_nodes = 1 << (level + 1)
        offsets = rng.standard_normal((n_nodes, k)) * (spec.depth_scale
                                                       ** level)
        idx = (np.arange(c) >> (depth - 1 - level)) & (n_nodes - 1)
        centers += offsets[idx]
    # Long-tailed label marginal.
    ranks = np.arange(1, c + 1, dtype=np.float64)
    p = ranks ** (-spec.zipf_a)
    p /= p.sum()
    label_perm = rng.permutation(c)

    def draw(n, seed_off):
        r = np.random.default_rng(spec.seed + seed_off)
        y = label_perm[r.choice(c, size=n, p=p)]
        x = centers[y] + spec.noise * r.standard_normal((n, k))
        return x.astype(np.float32), y.astype(np.int64)

    x_tr, y_tr = draw(n_train, 1)
    x_te, y_te = draw(n_test, 2)
    return x_tr, y_tr, x_te, y_te
