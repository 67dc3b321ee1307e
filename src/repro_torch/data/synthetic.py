"""Synthetic data: (a) hierarchically-clustered extreme-classification sets
mirroring the paper's cluster argument ("dogs vs bicycles ... Boston Terrier
vs French Bulldog", §2.2), and (b) deterministic token streams for LM runs.
Seeded host-side numpy, bit-equal to ``repro.data.synthetic`` for the same
arguments: a data position is a (seed, step) pair, nothing else to persist.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

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


def zipf_token_stream(vocab_size: int, batch: int, seq_len: int, *,
                      seed: int = 0, zipf_a: float = 1.2,
                      n_clusters: int = 64) -> Iterator[np.ndarray]:
    """Deterministic clustered-bigram token stream: tokens belong to
    ``n_clusters`` clusters; the next token stays in the previous token's
    cluster w.p. 0.8, a learnable bigram structure for the generator tree.

    Yields (batch, seq_len) int32 arrays; stream position is (seed, step).
    """
    c = vocab_size
    base = np.random.default_rng(seed)
    cluster_of = base.integers(0, n_clusters, c)
    members: list = [np.where(cluster_of == i)[0] for i in range(n_clusters)]
    members = [m if len(m) else np.array([0]) for m in members]
    ranks = np.arange(1, c + 1, dtype=np.float64) ** (-zipf_a)
    p_unigram = ranks / ranks.sum()
    perm = base.permutation(c)

    step = 0
    while True:
        r = np.random.default_rng((seed, step))
        toks = np.empty((batch, seq_len), np.int64)
        toks[:, 0] = perm[r.choice(c, size=batch, p=p_unigram)]
        stay = r.random((batch, seq_len)) < 0.8
        fresh = perm[r.choice(c, size=(batch, seq_len), p=p_unigram)]
        for t in range(1, seq_len):
            prev_cluster = cluster_of[toks[:, t - 1]]
            pick = r.integers(0, 1 << 30, batch)
            in_cluster = np.array(
                [members[pc][pk % len(members[pc])]
                 for pc, pk in zip(prev_cluster, pick)])
            toks[:, t] = np.where(stay[:, t], in_cluster, fresh[:, t])
        yield toks.astype(np.int32)
        step += 1
