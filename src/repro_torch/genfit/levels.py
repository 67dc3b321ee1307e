"""Level-parallel generator-tree fitting (the paper's §3 objective at scale).

The reference fit (:func:`repro_torch.core.tree_fit.fit_tree`) is a host-side
recursion: one Newton solve per node, 2C−1 of them, O(C) sequential phases.
This module runs the same alternating discrete/continuous optimization as a
**level-synchronous batched sweep**: every node at one depth is solved in one
vectorized pass, so fitting has O(log C) sequential phases and every phase is
a few segment-summed reductions plus one batched (k+1)×(k+1) Newton solve.
It is the port of ``repro.genfit.levels``, step for step:

* **Flat slot space.** The label→leaf permutation under construction is one
  ``perm`` tensor of ``C_pad`` slots; node membership at level ``l`` is
  ``slot >> shift`` with ``shift = depth − l``.
* **Segment-summed sufficient statistics.** The discrete step's Δ_y scores
  (Eq. 9), the Newton gradient and Hessian (Eq. 8), the per-node objective
  and the Armijo grid are sums over points keyed by node (or label). Every
  one goes through ``ops.segment_stats``, the hand-written CUDA kernel on the
  card, which adds in a fixed order, so a fit replays bit for bit. Sums over
  slots cover contiguous ranges of a level's nodes and are
  ``view(nseg, m, ...).sum(1)``; integer counts use ``index_add_`` on int32.
* **Balanced split as a rank rule.** Stable sorts of slots by ``(node, −Δ)``
  reproduce the reference's rule: top half goes right, padding sinks left and
  back-fills the right half when fewer than half the labels are real.
* **Batched Newton with per-node damping.** Per-point logits are carried
  across iterations, the whole 10-step Armijo grid comes from one directional
  pass, directions come from an inverse Hessian refreshed every 5 iterations
  (an unrolled batched Cholesky), nodes freeze on stable or 2-cycling
  partitions, frozen nodes' points are compacted out, intermediate solves are
  capped and stride-subsampled at shallow levels, and one full solve polishes
  the final partition of each level. The host drives the iteration and stops
  a level as soon as every node has retired.

The random starts of every level come from ``np.random.default_rng(seed)`` in
the reference's order, so both packages start each level from the same
numbers. Tensors live on ``device`` (the card unless the caller says
otherwise); the results come back as numpy arrays and are packed into the
port's :class:`~repro_torch.core.tree.Tree`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.core.tree import PAD_LOGIT, Tree, padded_size, validate
from repro_torch.core.tree_fit import FitConfig
from repro_torch.kernels import ops

# fp32 Newton cannot hit the reference's fp64 1e-8 step tolerance; clamp so
# converged nodes retire instead of oscillating at machine eps.
_MIN_TOL_F32 = 1e-5
# Refresh the inverted Hessian every this many Newton iterations: the
# per-node objective is concave, so a direction from any SPD matrix ascends
# and Armijo backtracking keeps the ascent monotone.
_HESS_EVERY = 5
# Armijo step grid t = 2^0 ... 2^-9, all evaluated from one pass.
_LS_GRID = 10
# Newton iterations of an intermediate (capped) solve between discrete steps.
_ALT_NEWTON = 3
# Intermediate solves subsample shallow levels to about this many points
# per node; the final partition is polished on all points.
_SUB_TARGET = 4096
# Point tensors are padded with zero-weight rows to a multiple of this many
# rows. torch's CPU kernels compute the last partial vector of an array with
# scalar code that rounds differently, so without the padding a real row's
# arithmetic would depend on how many rows follow it, and appended zero-weight
# rows would not be invisible.
_ROW_ALIGN = 64


def _newton_tol(cfg: FitConfig) -> float:
    return max(float(cfg.newton_tol), _MIN_TOL_F32)


def batched_inv_psd(a: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse for small d: an unrolled Cholesky, the rows of
    L⁻¹ by forward substitution, then L⁻ᵀL⁻¹ (the reference's arithmetic,
    ~3·d batched ops)."""
    n, d, _ = a.shape
    chol = a.new_zeros((n, d, 0))
    for j in range(d):
        prior = chol[:, j, :]                                  # (n, j)
        s = a[:, j, j] - (prior * prior).sum(-1)
        ljj = torch.sqrt(torch.clamp(s, min=1e-30))
        rest = a[:, j + 1:, j]
        if j:
            rest = rest - torch.einsum("nik,nk->ni", chol[:, j + 1:, :], prior)
        col = torch.cat([a.new_zeros((n, j)), ljj[:, None], rest / ljj[:, None]], dim=1)
        chol = torch.cat([chol, col[:, :, None]], dim=2)
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    linv = a.new_zeros((n, 0, d))
    for i in range(d):
        row = eye[i].expand(n, d)
        if i:
            row = row - torch.einsum("nk,nkj->nj", chol[:, i, :i], linv)
        linv = torch.cat([linv, (row / chol[:, i, i][:, None])[:, None, :]], dim=1)
    return torch.einsum("nki,nkj->nij", linv, linv)          # (LLᵀ)⁻¹


def _seg_sum1(vals: torch.Tensor, seg: torch.Tensor, nseg: int) -> torch.Tensor:
    """Segment sum of one value per point."""
    return ops.segment_stats(vals[:, None], seg, nseg)[:, 0]


def _count(seg: torch.Tensor, mask: torch.Tensor, nseg: int) -> torch.Tensor:
    """Exact per-segment count of the points where ``mask`` holds."""
    counts = torch.zeros((nseg,), dtype=torch.int32, device=seg.device)
    return counts.index_add_(0, seg, mask.to(torch.int32))


def _force_padding(theta, right_real, left_real, has_real, k: int) -> torch.Tensor:
    """Force decisions away from padding-only children (paper §3)."""
    w_lvl, b_lvl = theta[:, :k], theta[:, k]
    force = (right_real == 0) | ((left_real == 0) & has_real)
    w_lvl = torch.where(force[:, None], 0.0, w_lvl)
    b_lvl = torch.where(right_real == 0, -PAD_LOGIT, b_lvl)
    b_lvl = torch.where((left_real == 0) & has_real, PAD_LOGIT, b_lvl)
    return torch.cat([w_lvl, b_lvl[:, None]], dim=-1)


def make_newton_pieces(nseg: int, d: int, reg: float, newton_tol: float, device):
    """Batched damped (quasi-)Newton ascent on the per-node objective (Eq. 8).

    Returns ``(newton_start, refactor, newton_iter)``; :func:`run_newton`
    drives them from the host. The per-point logit ``z = xb·θ[seg]`` is
    carried across iterations, the Armijo grid is evaluated from one ``dz``
    pass, and ``outer`` is the (N, d²) table of ``xb⊗xb``, built once.
    """
    eye = torch.eye(d, dtype=torch.float32, device=device)
    tgrid = 0.5 ** torch.arange(_LS_GRID, dtype=torch.float32, device=device)

    def newton_start(theta, xb, zeta, wgt, seg, frozen):
        z = (xb * theta[seg]).sum(-1)
        per = _seg_sum1(wgt * F.logsigmoid(zeta * z), seg, nseg)
        obj = per - reg * (theta * theta).sum(-1)
        active = ~frozen
        return z, obj, active, active.any()

    def refactor(z, outer, zeta, wgt, seg):
        s = torch.sigmoid(torch.clamp(zeta * z, -60.0, 60.0))
        hcoef = wgt * s * (1.0 - s)
        hess = (ops.segment_stats(hcoef[:, None] * outer, seg, nseg).reshape(nseg, d, d)
                + (2.0 * reg + 1e-10) * eye)
        return batched_inv_psd(hess)

    def newton_iter(theta, z, obj, active, inv, xb, zeta, wgt, seg):
        s = torch.sigmoid(torch.clamp(zeta * z, -60.0, 60.0))
        gcoef = wgt * zeta * (1.0 - s)
        grad = ops.segment_stats(gcoef[:, None] * xb, seg, nseg) - 2.0 * reg * theta
        direction = torch.einsum("nij,nj->ni", inv, grad)
        slope = (grad * direction).sum(-1)
        act = active & torch.isfinite(slope) & (slope > 0.0)

        # Whole Armijo grid from one directional-logit pass.
        dz = (xb * direction[seg]).sum(-1)                       # (N,)
        zc = z[:, None] + tgrid[None, :] * dz[:, None]           # (N, T)
        per = ops.segment_stats(wgt[:, None] * F.logsigmoid(zeta[:, None] * zc),
                                seg, nseg)                       # (nseg, T)
        # |θ + t·d|² expanded into three per-node scalars.
        th_sq = (theta * theta).sum(-1)
        th_d = (theta * direction).sum(-1)
        d_sq = (direction * direction).sum(-1)
        objc = per - reg * (th_sq[:, None] + 2.0 * tgrid[None, :] * th_d[:, None]
                            + (tgrid ** 2)[None, :] * d_sq[:, None])
        ok = objc >= obj[:, None] + 1e-4 * tgrid[None, :] * slope[:, None]
        found = ok.any(-1)
        first = torch.argmax(ok.to(torch.int32), dim=-1)        # first accepted t
        t = torch.where(found, tgrid[first], 0.0)
        obj_new = torch.gather(objc, 1, first[:, None])[:, 0]
        upd = act & found
        theta = torch.where(upd[:, None], theta + t[:, None] * direction, theta)
        z = torch.where(upd[seg], z + t[seg] * dz, z)
        new_obj = torch.where(upd, obj_new, obj)
        step_inf = (t[:, None] * direction).abs().amax(-1)
        act = upd & (step_inf >= newton_tol)
        # fp32 plateau stop: an accepted step that no longer moves the
        # objective by a relative 1e-6 only crawls on rounding noise.
        act = act & ((new_obj - obj) >= 1e-6 * (obj.abs() + 1.0))
        return theta, z, new_obj, act, act.any()

    return newton_start, refactor, newton_iter


class _LevelPieces:
    """The building blocks of one level of a (C_pad, k) fit."""

    def __init__(self, c_pad: int, k: int, level: int, cfg: FitConfig, device):
        depth = c_pad.bit_length() - 1
        self.c_pad, self.k = c_pad, k
        self.shift = depth - level
        self.nseg = 1 << level
        self.m = c_pad >> level
        self.half = self.m >> 1
        self.slots = torch.arange(c_pad, device=device)
        self.node_of_slot = self.slots >> self.shift
        self.newton = make_newton_pieces(self.nseg, k + 1, cfg.reg, _newton_tol(cfg), device)

    def _per_node(self, slot_vals: torch.Tensor) -> torch.Tensor:
        """Sum over each node's m contiguous slots."""
        return slot_vals.reshape(self.nseg, self.m, *slot_vals.shape[1:]).sum(1)

    def prep(self, y, wgt, perm, slot_of_label, num_labels: int):
        node_of_point = (slot_of_label >> self.shift)[y]
        is_pad_slot = perm >= num_labels
        n_real = self._per_node((~is_pad_slot).float())
        # Only positively-weighted points count: zero-weight rows are no-ops
        # in every reduction (the subtree fitters pad with them).
        npts = _count(node_of_point, wgt > 0, self.nseg)
        # Trivial nodes (all padding, or real labels but no data) keep the
        # natural slot-order split and never iterate.
        trivial = (n_real == 0) | (npts == 0)
        natural = (self.slots & (self.m - 1)) >= self.half
        split0 = trivial[self.node_of_slot] & natural
        return dict(node_of_point=node_of_point, is_pad_slot=is_pad_slot,
                    n_real=n_real, trivial=trivial, split0=split0)

    def init_theta(self, s_lab, perm, trivial, v0, v_restart):
        """Per-node dominant eigenvector of the centred per-label feature-sum
        matrix: 20 power iterations, batched over the level's nodes."""
        s_slot = s_lab[perm]
        mean = self._per_node(s_slot) / float(self.m)
        sc = s_slot - mean[self.node_of_slot]
        v = v0 / (torch.linalg.norm(v0, dim=-1, keepdim=True) + 1e-12)
        for _ in range(20):
            t = (sc * v[self.node_of_slot]).sum(-1)
            u = self._per_node(t[:, None] * sc)
            nrm = torch.linalg.norm(u, dim=-1, keepdim=True)
            v = torch.where(nrm < 1e-12, 0.01 * v_restart, u / torch.clamp(nrm, min=1e-30))
        theta0 = torch.cat([v, v.new_zeros((self.nseg, 1))], dim=-1)
        return torch.where(trivial[:, None], 0.0, theta0)

    def discrete(self, theta, split, split_prev, frozen, xb, y, wgt, perm,
                 slot_of_label, node_of_point, is_pad_slot):
        # Δ_y = Σ_{x∈D_y} (w·x + b) (Eq. 9); the top half goes right.
        z = (xb * theta[node_of_point]).sum(-1)
        delta = _seg_sum1(wgt * z, y, self.c_pad)
        delta_slot = torch.where(is_pad_slot, -torch.inf, delta[perm])
        o1 = torch.argsort(-delta_slot, stable=True)
        order = o1[torch.argsort(self.node_of_slot[o1], stable=True)]
        new_split = torch.zeros((self.c_pad,), dtype=torch.bool, device=perm.device)
        new_split[order] = (self.slots & (self.m - 1)) < self.half
        new_split = torch.where(frozen[self.node_of_slot], split, new_split)
        # Freeze on a stable partition (the reference's per-node break) or on
        # a 2-cycle (new == two alternations ago).
        changed1 = (new_split != split).reshape(self.nseg, self.m).any(1)
        changed2 = (new_split != split_prev).reshape(self.nseg, self.m).any(1)
        frozen = frozen | ~changed1 | ~changed2
        side_pt = new_split[slot_of_label][y]
        zeta = side_pt.float() * 2.0 - 1.0
        return new_split, frozen, zeta, frozen.all()

    def finalize(self, theta, split, perm, is_pad_slot, n_real):
        right_real = self._per_node((~is_pad_slot & split).float())
        left_real = self._per_node((~is_pad_slot & ~split).float())
        theta_out = _force_padding(theta, right_real, left_real, n_real > 0, self.k)
        # Permute slots: left-side labels first, stable within a side (the
        # reference's concat([lab[~ζ], lab[ζ]]) order).
        o1p = torch.argsort(split.to(torch.int32), stable=True)
        order2 = o1p[torch.argsort(self.node_of_slot[o1p], stable=True)]
        new_perm = perm[order2]
        new_slot = torch.empty_like(perm)
        new_slot[new_perm] = self.slots
        return theta_out, new_perm, new_slot


def _compact(n_total: int, idx: np.ndarray, xb, outer, zeta, wgt, seg):
    """Gather the points of still-active nodes into a padded pow-4 bucket.

    Active nodes' sums are over the same point subsequence in the same order,
    and padding rows carry weight 0, so their statistics do not change while
    frozen nodes' points stop costing O(N) per iteration.
    """
    n_b = n_total
    while n_b // 4 >= max(len(idx), 1024):
        n_b //= 4
    n_b = -(-n_b // _ROW_ALIGN) * _ROW_ALIGN
    if n_b >= n_total:
        return None
    pad = n_b - len(idx)
    idx_t = torch.from_numpy(np.concatenate([idx, np.zeros(pad, np.int64)])).to(xb.device)
    valid = torch.arange(n_b, device=xb.device) < len(idx)
    return (xb[idx_t], outer[idx_t], zeta[idx_t],
            torch.where(valid, wgt[idx_t], 0.0), seg[idx_t])


def run_newton(newton_pieces, theta, frozen, xb, outer, zeta, wgt, seg,
               seg_host: np.ndarray, max_newton: int, subsample_target: int = 0):
    """Drive one batched Newton solve from the host: compact away frozen
    nodes' points, then iterate (refreshing the Hessian factor every
    ``_HESS_EVERY`` steps) until every node retires or ``max_newton``.

    ``subsample_target > 0`` stride-samples the active points to about
    ``subsample_target`` per node, weights scaled by the stride (the
    intermediate solves of shallow levels, never the polish).
    """
    newton_start, refactor, newton_iter = newton_pieces
    n_total = seg_host.shape[0]
    idx = np.nonzero(~frozen.cpu().numpy()[seg_host])[0]
    stride = 1
    if subsample_target:
        # The level width (not the active-node count) keeps the stride
        # deterministic and conservative.
        stride = max(1, len(idx) // (int(frozen.shape[0]) * subsample_target))
    packed = None
    if stride > 1:
        packed = _compact(n_total, idx[::stride], xb, outer, zeta, wgt * float(stride), seg)
    if packed is None:
        packed = _compact(n_total, idx, xb, outer, zeta, wgt, seg)
    xb_a, outer_a, zeta_a, wgt_a, seg_a = (
        packed if packed is not None else (xb, outer, zeta, wgt, seg))
    z, obj, active, any_active = newton_start(theta, xb_a, zeta_a, wgt_a, seg_a, frozen)
    it = 0
    inv = None
    while bool(any_active) and it < max_newton:
        if it % _HESS_EVERY == 0:
            inv = refactor(z, outer_a, zeta_a, wgt_a, seg_a)
        theta, z, obj, active, any_active = newton_iter(
            theta, z, obj, active, inv, xb_a, zeta_a, wgt_a, seg_a)
        it += 1
    return theta


def _run_level(pieces: _LevelPieces, xb, outer, y, wgt, s_lab, perm, slot_of_label,
               num_labels: int, v0, v_restart, cfg: FitConfig):
    """Host-driven alternation for one level: discrete re-partition, then
    batched Newton until every node retires (early exit on the host)."""
    aux = pieces.prep(y, wgt, perm, slot_of_label, num_labels)
    theta = pieces.init_theta(s_lab, perm, aux["trivial"], v0, v_restart)
    split, frozen = aux["split0"], aux["trivial"]
    split_prev = split
    seg = aux["node_of_point"]
    seg_host = seg.cpu().numpy()
    zeta = None
    for _ in range(cfg.max_alternations):
        new_split, frozen, zeta, all_frozen = pieces.discrete(
            theta, split, split_prev, frozen, xb, y, wgt, perm, slot_of_label, seg,
            aux["is_pad_slot"])
        split_prev, split = split, new_split
        if bool(all_frozen):
            break
        # Capped solve: intermediate alternations only need improvement.
        theta = run_newton(pieces.newton, theta, frozen, xb, outer, zeta, wgt, seg,
                           seg_host, min(_ALT_NEWTON, cfg.max_newton),
                           subsample_target=_SUB_TARGET)
    if zeta is not None:
        # Full-precision polish of every data-carrying node on the final
        # partition.
        theta = run_newton(pieces.newton, theta, aux["trivial"], xb, outer, zeta, wgt,
                           seg, seg_host, cfg.max_newton)
    return pieces.finalize(theta, split, perm, aux["is_pad_slot"], aux["n_real"])


def _prep_data(features, labels, num_labels: int, sample_weight):
    x = np.asarray(features, np.float32)
    y = np.asarray(labels, np.int64)
    if x.ndim != 2 or y.shape != (x.shape[0],):
        raise ValueError(f"features must be (N, k) and labels (N,), got {x.shape} "
                         f"and {y.shape}")
    if y.size and not (0 <= y.min() and y.max() < num_labels):
        raise ValueError(f"labels must lie in [0, {num_labels})")
    wgt = (np.ones(len(y), np.float32) if sample_weight is None
           else np.asarray(sample_weight, np.float32))
    return x, y, wgt


def _point_tensors(x: np.ndarray, y: np.ndarray, wgt: np.ndarray, device):
    """The points on ``device``, padded with zero-weight rows to a multiple
    of ``_ROW_ALIGN``: ``(xb, outer, y, wgt)`` with ``xb`` the features and a
    bias column and ``outer`` the flattened xb⊗xb table of the Hessian,
    constant across a whole fit."""
    pad = -len(y) % _ROW_ALIGN
    if pad:
        x = np.concatenate([x, np.zeros((pad, x.shape[1]), x.dtype)])
        y = np.concatenate([y, np.zeros(pad, y.dtype)])
        wgt = np.concatenate([wgt, np.zeros(pad, wgt.dtype)])
    xj = torch.from_numpy(x).to(device)
    xb = torch.cat([xj, xj.new_ones((x.shape[0], 1))], dim=-1)
    d = xb.shape[1]
    outer = (xb[:, :, None] * xb[:, None, :]).reshape(-1, d * d)
    return xb, outer, torch.from_numpy(y).to(device), torch.from_numpy(wgt).to(device)


def _fit_levels(x, y, wgt, num_labels: int, c_pad: int, cfg: FitConfig,
                n_levels: int, device):
    """Run the level sweep for ``n_levels`` levels from the root.

    Returns host arrays ``(w_all, b_all, perm, slot_of_label)``; node rows
    below the fitted levels stay zero (the sharded fitter fills them).
    """
    k = x.shape[1]
    rng = np.random.default_rng(cfg.seed)
    xb, outer, yj, wj = _point_tensors(x, y, wgt, device)
    # Per-label weighted feature sums: level-independent, computed once.
    s_lab = ops.segment_stats(xb[:, :k] * wj[:, None], yj, c_pad)
    perm = torch.arange(c_pad, device=device)
    slot_of_label = torch.arange(c_pad, device=device)

    w_all = np.zeros((c_pad - 1, k), np.float32)
    b_all = np.zeros((c_pad - 1,), np.float32)
    for level in range(n_levels):
        pieces = _LevelPieces(c_pad, k, level, cfg, device)
        n_lvl = 1 << level
        v0 = torch.from_numpy(rng.standard_normal((n_lvl, k)).astype(np.float32)).to(device)
        v_restart = torch.from_numpy(
            rng.standard_normal((n_lvl, k)).astype(np.float32)).to(device)
        theta, perm, slot_of_label = _run_level(
            pieces, xb, outer, yj, wj, s_lab, perm, slot_of_label, num_labels, v0,
            v_restart, cfg)
        th = theta.cpu().numpy()
        w_all[n_lvl - 1:2 * n_lvl - 1] = th[:, :k]
        b_all[n_lvl - 1:2 * n_lvl - 1] = th[:, k]
    return w_all, b_all, perm.cpu().numpy(), slot_of_label.cpu().numpy()


def pack_tree(w_all, b_all, perm, num_labels: int, device) -> Tree:
    """Assemble a :class:`Tree` on ``device`` from level arrays and the final
    slot permutation (``perm[leaf] = label``, padding ids ≥ num_labels)."""
    perm = np.asarray(perm, np.int64)
    real = perm < num_labels
    label_to_leaf = np.zeros((num_labels,), np.int64)
    label_to_leaf[perm[real]] = np.nonzero(real)[0]
    leaf_to_label = np.where(real, perm, 0)
    return validate(Tree(
        w=torch.from_numpy(np.asarray(w_all, np.float32)).to(device),
        b=torch.from_numpy(np.asarray(b_all, np.float32)).to(device),
        label_to_leaf=torch.from_numpy(label_to_leaf).to(device),
        leaf_to_label=torch.from_numpy(leaf_to_label).to(device)), num_labels)


def fit_tree_levelwise(features, labels, num_labels: int, sample_weight=None,
                       config: Optional[FitConfig] = None,
                       c_pad: Optional[int] = None, device="cuda") -> Tree:
    """Level-parallel fit: the objective and partition rules of
    :func:`repro_torch.core.tree_fit.fit_tree` in O(log C) sequential phases.

    features: (N, k) float32 numpy; labels: (N,) ints in [0, num_labels).
    ``c_pad`` forces the padded leaf count (a power of two ≥
    ``padded_size(num_labels)``); the sharded and incremental fitters use it
    for subtrees. The tree's tensors are created on ``device``.
    """
    dev = device_lib.resolve(device)
    cfg = config or FitConfig()
    x, y, wgt = _prep_data(features, labels, num_labels, sample_weight)
    c_pad = c_pad or padded_size(num_labels)
    if c_pad < padded_size(num_labels) or c_pad & (c_pad - 1):
        raise ValueError(f"c_pad must be a power of two >= {padded_size(num_labels)}, "
                         f"got {c_pad}")
    depth = c_pad.bit_length() - 1
    w_all, b_all, perm, _ = _fit_levels(x, y, wgt, num_labels, c_pad, cfg, depth, dev)
    return pack_tree(w_all, b_all, perm, num_labels, dev)
