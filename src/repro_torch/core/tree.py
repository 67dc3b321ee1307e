"""Probabilistic binary decision tree — the paper's adversarial generator (§3).

The tree is *balanced* with ``C_pad = 2**depth`` leaves (``C_pad >= C``;
surplus leaves are uninhabited "padding labels" whose probability is forced
to zero, exactly as in the paper). Internal nodes are stored in **level
order** (root = 0, children of node ``i`` are ``2i+1`` and ``2i+2``) so that
all node parameters live in two dense tensors and every tree operation is a
batched gather + dot.

- ``log_prob(tree, x, y)``       — O(k·depth) per example  (paper req. (iii))
- ``sample(tree, x, ...)``       — O(k·depth) ancestral sampling (req. (ii))
- ``log_prob_all(tree, x)``      — O(k·C) dense evaluation over all labels,
  the bias-removal term ``log p_n(y|x)`` of Eq. 5; on the card it runs the
  ``tree_logprob_all`` CUDA kernel.
- ``beam_search(tree, x, beam, topk)`` — O(beam·k·depth) batched beam
  descent returning the top-``topk`` labels by ``log p_n(y|x)``, the
  sublinear candidate generator behind
  :func:`repro_torch.core.heads.predictive_topk`.

Label maps are int64, torch's index type.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.kernels import ops

# Decision logit magnitude used to force p(padding) = 0. sigmoid(-30) ~ 9e-14.
PAD_LOGIT = 30.0


class Tree(NamedTuple):
    """Packed tree parameters.

    Attributes:
      w:  (n_nodes, k) per-node weight vectors; n_nodes = 2**depth - 1.
      b:  (n_nodes,)  per-node biases.
      label_to_leaf: (C,) int64 — leaf index (0..C_pad-1) of each real label.
      leaf_to_label: (C_pad,) int64 — inverse map; padding leaves hold 0.
    """

    w: torch.Tensor
    b: torch.Tensor
    label_to_leaf: torch.Tensor
    leaf_to_label: torch.Tensor

    @property
    def depth(self) -> int:
        n_nodes = self.b.shape[0]
        d = (n_nodes + 1).bit_length() - 1
        if (1 << d) != n_nodes + 1:
            raise ValueError(f"n_nodes={n_nodes} is not 2**d - 1")
        return d

    @property
    def num_labels(self) -> int:
        return self.label_to_leaf.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.w.shape[-1]


def padded_size(num_labels: int) -> int:
    """Smallest power of two >= num_labels (>= 2 so depth >= 1)."""
    return max(2, 1 << (num_labels - 1).bit_length())


def init_tree(generator: torch.Generator, num_labels: int, feature_dim: int,
              scale: float = 0.01, device="cuda") -> Tree:
    """Random tree over labels in natural order (fitting replaces this).

    The weights are drawn on ``generator``'s device and moved to ``device``.
    """
    dev = device_lib.resolve(device)
    c_pad = padded_size(num_labels)
    n_nodes = c_pad - 1
    w = scale * torch.randn((n_nodes, feature_dim), generator=generator,
                            device=generator.device, dtype=torch.float32)
    b = _force_padding(torch.zeros((n_nodes,), dtype=torch.float32,
                                   device=dev), num_labels, c_pad)
    leaves = torch.arange(c_pad, device=dev)
    return Tree(w=w.to(dev), b=b,
                label_to_leaf=torch.arange(num_labels, device=dev),
                leaf_to_label=torch.where(leaves < num_labels, leaves, 0))


def _force_padding(b: torch.Tensor, num_labels: int, c_pad: int) -> torch.Tensor:
    """Force decisions away from padding-only subtrees (identity layout).

    With labels laid out in natural leaf order, leaves [num_labels, c_pad)
    are padding. A node whose *right* subtree is entirely padding must
    always go left (b = -PAD_LOGIT). Node j of a level owns the right
    subtree starting at leaf (2j + 1) * leaves_per_child; one vector
    comparison per level replaces a loop over all c_pad - 1 nodes.
    """
    depth = c_pad.bit_length() - 1
    force_left = torch.zeros((c_pad - 1,), dtype=torch.bool, device=b.device)
    for level in range(depth):
        n_lvl = 1 << level
        leaves_per_child = c_pad >> (level + 1)
        j = torch.arange(n_lvl, device=b.device)
        force_left[n_lvl - 1:2 * n_lvl - 1] = (
            (2 * j + 1) * leaves_per_child >= num_labels)
    return torch.where(force_left, torch.full_like(b, -PAD_LOGIT), b)


def _node_scores(tree: Tree, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """z = w[idx]·x + b[idx] for a batch of node indices idx (same shape as
    x[..., 0])."""
    return (tree.w[idx] * x).sum(dim=-1) + tree.b[idx]


def log_prob(tree: Tree, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log p_n(y|x). x: (..., k), y: (...,) int. Returns (...,) float32.

    Cost O(depth·k) per example: one gather + dot per tree level (Eq. 7).
    """
    depth = tree.depth
    leaf = tree.label_to_leaf[y]
    acc = torch.zeros(y.shape, dtype=torch.float32, device=x.device)
    for level in range(depth):
        # Node visited at `level` on the path to `leaf`, and the branch taken.
        idx = (1 << level) - 1 + (leaf >> (depth - level))
        bit = (leaf >> (depth - 1 - level)) & 1
        z = _node_scores(tree, x, idx)
        zeta = 2.0 * bit.to(z.dtype) - 1.0
        acc = acc + F.logsigmoid(zeta * z)
    return acc


def sample(tree: Tree, x: torch.Tensor,
           generator: Optional[torch.Generator] = None,
           u: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ancestral sampling y' ~ p_n(·|x). Returns (labels, log_probs).

    x: (..., k). One uniform per level decides each branch: pass them as
    ``u`` (shape x.shape[:-1] + (depth,)), or a ``generator`` to draw them.
    Cost O(depth·k) per sample — the paper's O(k log C) bound. The
    log-probability of the drawn label falls out of the walk for free
    (needed for bias removal / regularizer, Eq. 5/6).
    """
    depth = tree.depth
    batch_shape = x.shape[:-1]
    if u is None:
        if generator is None:
            raise ValueError("sample needs a generator or the uniforms u")
        u = torch.rand(batch_shape + (depth,), generator=generator,
                       device=generator.device).to(x.device)
    idx = torch.zeros(batch_shape, dtype=torch.int64, device=x.device)
    acc = torch.zeros(batch_shape, dtype=torch.float32, device=x.device)
    for level in range(depth):
        z = _node_scores(tree, x, idx)
        go_right = u[..., level] < torch.sigmoid(z)
        acc = acc + torch.where(go_right, F.logsigmoid(z), F.logsigmoid(-z))
        idx = 2 * idx + 1 + go_right.long()
    leaf = idx - ((1 << depth) - 1)
    return tree.leaf_to_label[leaf], acc


def log_prob_all(tree: Tree, x: torch.Tensor) -> torch.Tensor:
    """log p_n(y|x) for *all* real labels. x: (..., k) → (..., C).

    The per-leaf log-probs come from ``ops.tree_logprob_all`` (the CUDA
    kernel on the card, its plain version on the CPU) in leaf order; the
    leaf of each real label is then selected. Used for full-vocab bias
    removal at serving time (Eq. 5).
    """
    k = x.shape[-1]
    flat = x.reshape(-1, k).float().contiguous()
    leaf_logp = ops.tree_logprob_all(tree.w, tree.b, flat)       # (B, C_pad)
    return leaf_logp[:, tree.label_to_leaf].reshape(
        x.shape[:-1] + (tree.num_labels,))


def beam_search(tree: Tree, x: torch.Tensor, beam: int, topk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``topk`` labels by log p_n(y|x) via batched beam descent.

    x: (..., k) → (labels, log_probs), each (..., topk). Cost
    O(beam·k·depth) = O(beam·k·log C) per example — sublinear in C, vs the
    O(C·k) dense pass of :func:`log_prob_all`. With ``beam >= C_pad`` the
    search is exhaustive and exact.

    Inactive beam slots carry -inf and duplicate node 0; real paths always
    have finite log-prob (padding forcing uses finite PAD_LOGIT), so -inf
    uniquely marks dead slots. Padding leaves are masked out of the result:
    their slots return label -1 with log-prob -inf, and never a real label.
    """
    depth = tree.depth
    c_pad = 1 << depth
    if beam < 1 or topk < 1:
        raise ValueError(
            f"beam and topk must be >= 1, got beam={beam}, topk={topk}")
    beam = min(beam, c_pad)
    n_out = topk
    topk = min(topk, beam)
    batch_shape = x.shape[:-1]

    nodes = torch.zeros(batch_shape + (beam,), dtype=torch.int64,
                        device=x.device)
    logp = torch.full(batch_shape + (beam,), -torch.inf, dtype=torch.float32,
                      device=x.device)
    logp[..., 0] = 0.0
    xb = x[..., None, :]
    for _ in range(depth):
        z = _node_scores(tree, xb, nodes)                         # (..., beam)
        cand_logp = torch.cat([logp + F.logsigmoid(-z),
                               logp + F.logsigmoid(z)], dim=-1)   # (..., 2·beam)
        cand_nodes = torch.cat([2 * nodes + 1, 2 * nodes + 2], dim=-1)
        logp, sel = torch.topk(cand_logp, beam, dim=-1)
        nodes = torch.gather(cand_nodes, -1, sel)

    leaf = nodes - (c_pad - 1)
    label = tree.leaf_to_label[leaf]
    # A leaf is real iff the label<->leaf maps round-trip (padding leaves
    # all alias label 0); dead beam slots are caught by the -inf check.
    is_real = (tree.label_to_leaf[label] == leaf) & torch.isfinite(logp)
    logp = torch.where(is_real, logp, -torch.inf)
    label = torch.where(is_real, label, -1)
    top_logp, sel = torch.topk(logp, topk, dim=-1)
    top_label = torch.gather(label, -1, sel)
    if n_out > topk:   # keep the documented (..., topk) output shape
        top_logp = F.pad(top_logp, (0, n_out - topk), value=-torch.inf)
        top_label = F.pad(top_label, (0, n_out - topk), value=-1)
    return top_label, top_logp


def prob_mass_real(tree: Tree, x: torch.Tensor) -> torch.Tensor:
    """Total probability mass on real (non-padding) labels; ~1.0 by
    construction. Test/diagnostic helper."""
    return torch.exp(torch.logsumexp(log_prob_all(tree, x), dim=-1))


def validate(tree: Tree, num_labels: int) -> Tree:
    """Structural invariants: tensor shapes and the leaf↔label bijection.

    Cheap O(C) checks that raise ``ValueError``. Returns the tree for
    chaining.
    """
    c_pad = 1 << tree.depth
    checks = [
        (tuple(tree.w.shape) == (c_pad - 1, tree.feature_dim),
         f"w shape {tuple(tree.w.shape)}"),
        (tuple(tree.b.shape) == (c_pad - 1,), f"b shape {tuple(tree.b.shape)}"),
        (tuple(tree.label_to_leaf.shape) == (num_labels,),
         f"label_to_leaf shape {tuple(tree.label_to_leaf.shape)}"),
        (tuple(tree.leaf_to_label.shape) == (c_pad,),
         f"leaf_to_label shape {tuple(tree.leaf_to_label.shape)}"),
    ]
    for ok, what in checks:
        if not ok:
            raise ValueError(f"invalid tree: {what}")
    l2l = tree.label_to_leaf
    if torch.unique(l2l).numel() != num_labels:
        raise ValueError("invalid tree: label->leaf not injective")
    roundtrip = tree.leaf_to_label[l2l]
    if not bool((roundtrip == torch.arange(num_labels, device=l2l.device)).all()):
        raise ValueError("invalid tree: leaf_to_label does not invert "
                         "label_to_leaf")
    return tree
