"""Optimizers for the linear head: Adagrad (paper §5), AdamW, SM3 and SGD,
global-norm clipping, LR schedules, and dense or sparse-row updates.

Params are a head ``{w (C, K), b (C,)}`` (:class:`~repro_torch.core.heads.
HeadParams`). Its gradient is either dense, a ``HeadParams`` of the same
shapes, or one :class:`~repro_torch.optim.sparse.SparseRows`. A sparse
gradient is applied as O(U·K) row updates: gather the touched rows of
params and of every piece of state, run the same per-leaf rule the dense
path runs, and write the rows back in place with ``index_copy_``. That
in-place write is the port's form of the JAX package's buffer donation: the
step never copies the (C, K) tables, so its cost does not depend on C. The
dense path returns new tensors.

Params may also be a tree of dicts and lists (an LM's): its gradient tree
has the same structure, except that a ``SparseRows`` may stand in for a
``{"w", "b"}`` subtree (the sampled head) or for a bare row table (the
input embedding, ``db`` None). Every leaf of a tree, dense or sparse, is
updated in place, so an LM step holds one copy of its parameters and
state. A leaf whose path has a component named "head" takes ``head_name``
and ``state_dtype``; every other leaf takes ``name`` with float32 state.

Memory-cheap head state:

* ``sm3`` keeps one (C,) row cover and one (K,) column cover instead of a
  full (C, K) second-moment slab (Anil et al., "Memory-Efficient Adaptive
  Optimization"), in the *monotone-max* variant (covers never decrease), so
  the sparse touched-rows update is exactly the dense update. A 1-D leaf
  keeps a full accumulator (SM3 degenerates to Adagrad there).
* ``state_dtype`` ("fp32" | "bf16" | "int8") selects the *storage* of the
  head accumulators (:mod:`repro_torch.optim.compression`); compute is
  always fp32, and conversion happens only at the gather/scatter boundary.
  "int8" applies to first moments only; second moments degrade to bf16
  (:func:`_nu_sd`).
* AdamW rows carry per-row ``last``-touched steps; a row idle for ``gap``
  steps replays its missed zero-gradient updates (momentum decay, bias
  correction, decoupled weight decay) when next touched, so lazy sparse
  AdamW matches dense AdamW (exactly up to the replay horizon, ~1e-9
  beyond). The replay is a host loop of plain tensor operations: one
  synchronize to read the largest gap, then up to the horizon (197 steps
  at beta1 = 0.9) iterations.

Scalars follow the JAX package's float32 arithmetic: bias corrections are
float32 powers, the catch-up's per-row learning rates come from the
float32 tensor form of :func:`schedule`.

Under a ``("data", "model")`` mesh (``mesh=``) the head's and the
embedding's tables are row-sharded (:mod:`repro_torch.parallel.sharding`)
and their sparse rows go through
:func:`repro_torch.parallel.collectives.sharded_rows_update`: a rank
writes only the rows it owns, SM3's column cover is recombined by an
``all_reduce`` MAX, and AdamW's catch-up skips the clamped rows a rank
does not own. The gradients arrive already summed over ``data``, the same
on every data rank: with more than one data rank a ``SparseRows`` holds
only the rank's ``model`` slice of the rows (every id touched there on any
data rank, a zero sum included), whose squares :func:`global_norm` sums
over ``model`` once (``sparse_axes``: ``collectives.data_sum_axes``). A ``SparseRows`` handed to
:func:`apply_updates` by another caller is whole and replicated. A dense
leaf (the trunk, and under a dense head the head and the embedding) is a
rank's part where the caller names it in
``split_dims`` (its path: the axis, ``"model"``, ``"data"`` or None, that
cuts each dim; ``parallel.sharding.split_dims``), else whole:
:func:`global_norm` sums the split leaves' squares over the axes that cut
them and counts the whole ones once, so the clip decides alike on every
rank; Adagrad, AdamW and SGD are elementwise and update a part as they
update the whole; SM3's column cover is whole, its row cover the rank's
rows, and each cover's maximum over a cut dim takes an ``all_reduce`` MAX
over that dim's axis, as the reference recombines it with ``pmax``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree_util
from repro_torch.optim import compression
from repro_torch.optim import sparse as sparse_lib
from repro_torch.optim.compression import QuantizedRows

_RULES = ("adagrad", "adamw", "sgd", "sm3")
_STATE_DTYPES = ("fp32", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adagrad"           # adagrad | adamw | sgd | sm3
    learning_rate: float = 0.01
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    adagrad_init: float = 0.0       # initial accumulator (paper uses 0)
    clip_norm: float = 0.0          # 0 = off
    warmup_steps: int = 0
    decay_steps: int = 0            # cosine decay horizon; 0 = constant
    head_name: Optional[str] = None  # head-leaf rule override (e.g. "sm3")
    state_dtype: str = "fp32"       # head accumulator storage: fp32|bf16|int8
    lazy_horizon: int = 0           # adamw catch-up replay cap; 0 = auto


class Sm3Cover(NamedTuple):
    """Factored second moment for a (C, K) table: ν_ij ≈ min(row_i, col_j).

    row: (C,) in the configured storage dtype (bf16 under bf16/int8).
    col: (K,) fp32 always: K elements are too few to be worth shrinking,
         and the column cover is the one piece every update reads.
    """
    row: torch.Tensor
    col: torch.Tensor


_STATE_BOXES = (Sm3Cover, QuantizedRows)


class OptState(NamedTuple):
    step: int         # steps taken
    mu: Any           # 1st moments (adamw) as a HeadParams of storage leaves, or None
    nu: Any           # 2nd moments / adagrad accumulators / Sm3Cover leaves, or None (sgd)
    last: Any = None  # per-row int32 last-touched step (adamw), or None


def _rule(cfg: OptimizerConfig) -> Tuple[str, str]:
    """The head's (update rule, state dtype); every leaf of a standalone
    head is a head leaf, so ``head_name`` overrides ``name``."""
    name = cfg.head_name or cfg.name
    if name not in _RULES:
        raise ValueError(f"unknown optimizer {name!r}; expected one of {_RULES}")
    if cfg.state_dtype not in _STATE_DTYPES:
        raise ValueError(f"unknown state_dtype {cfg.state_dtype!r}")
    return name, cfg.state_dtype


def _nu_sd(sd: str) -> str:
    """Storage dtype for second moments: int8 degrades to bf16.

    Linear per-row int8 zeroes every entry below rowmax/127, and nu enters
    the update through 1/(sqrt(nu)+eps): a zeroed entry turns a tiny
    accumulator into a ~1/eps step and the loss diverges within steps.
    First moments enter linearly and tolerate int8, so
    ``state_dtype="int8"`` means int8 mu + bf16 nu.
    """
    return "bf16" if sd == "int8" else sd


def _is_tree(params) -> bool:
    """A tree of dicts and lists (an LM's params), not a standalone head."""
    return isinstance(params, (dict, list))


def _leaf_rules(cfg: OptimizerConfig, paths):
    """(rule, state dtype) per leaf path: head leaves take ``head_name`` and
    ``state_dtype``, every other leaf ``name`` with float32 state."""
    _rule(cfg)
    return [((cfg.head_name or cfg.name), cfg.state_dtype) if "head" in path
            else (cfg.name, "fp32") for path in paths]


def _leaf_state(cfg: OptimizerConfig, name: str, sd: str, p, col_len: Optional[int] = None):
    """(mu, nu, last) storage of one leaf under its rule. ``col_len``: the
    length of SM3's column cover where ``p`` holds a rank's part of the
    columns (the cover is whole)."""
    def full(shape, state_dtype, fill=0.0):
        return compression.full_rows(shape, fill, state_dtype, p.device)
    if name == "adamw":
        return (full(p.shape, sd), full(p.shape, _nu_sd(sd)),
                torch.zeros(p.shape[:1], dtype=torch.int32, device=p.device))
    if name == "adagrad":
        return None, full(p.shape, _nu_sd(sd), cfg.adagrad_init), None
    if name == "sm3":
        if p.dim() == 2:
            return None, Sm3Cover(row=full(p.shape[:1], _nu_sd(sd)),
                                  col=full((col_len or p.shape[1],), "fp32")), None
        # 1-D / 3-D+ leaves: SM3's per-element cover degenerates to the
        # full Adagrad accumulator.
        return None, full(p.shape, _nu_sd(sd)), None
    return None, None, None


def init_opt_state(cfg: OptimizerConfig, params, col_lens=None) -> OptState:
    """Zero step and zero state (Adagrad's accumulators at
    ``adagrad_init``), in the storage ``state_dtype`` names, on the params'
    device (``meta`` params give a state that holds no memory). A tree of
    params gets state trees of the same structure. ``col_lens`` maps the
    path of a leaf that holds a rank's part of its columns to their full
    count: SM3's column cover stays whole (module docstring)."""
    col_lens = col_lens or {}
    if _is_tree(params):
        pairs, spec = tree_util.flatten_with_paths(params)
        paths = [path for path, _ in pairs]
        flat = [p for _, p in pairs]
        rules = _leaf_rules(cfg, paths)
        rebuild = lambda leaves: tree_util.unflatten(spec, leaves)  # noqa: E731
    else:
        flat = list(params)
        paths = [None] * len(flat)
        rules = [_rule(cfg)] * len(flat)
        rebuild = lambda leaves: type(params)(*leaves)  # noqa: E731
    states = [_leaf_state(cfg, name, sd, p, col_lens.get(path))
              for p, path, (name, sd) in zip(flat, paths, rules)]

    def pack(i):
        leaves = [st[i] for st in states]
        return None if all(x is None for x in leaves) else rebuild(leaves)

    return OptState(step=0, mu=pack(0), nu=pack(1), last=pack(2))


def schedule(cfg: OptimizerConfig, step):
    """The learning rate at ``step``: linear warmup, then cosine decay.

    A Python ``step`` gives a Python float. A tensor of steps gives the
    float32 rate of each, computed in float32 as the JAX package computes
    it (the AdamW catch-up's per-row steps).
    """
    if isinstance(step, torch.Tensor):
        s = step.float()
        lr = torch.full_like(s, cfg.learning_rate)
        if cfg.warmup_steps:
            lr = lr * torch.clamp((s + 1.0) / cfg.warmup_steps, max=1.0)
        if cfg.decay_steps:
            frac = torch.clamp((s - cfg.warmup_steps)
                               / max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
            lr = lr * (0.5 * (1.0 + torch.cos(math.pi * frac)))
        return lr
    lr = cfg.learning_rate
    s = float(step)
    if cfg.warmup_steps:
        lr = lr * min(1.0, (s + 1.0) / cfg.warmup_steps)
    if cfg.decay_steps:
        frac = min(max((s - cfg.warmup_steps)
                       / max(1, cfg.decay_steps - cfg.warmup_steps), 0.0), 1.0)
        lr = lr * (0.5 * (1.0 + math.cos(math.pi * frac)))
    return lr


def global_norm(grads, mesh=None, split_dims=None, sparse_axes=()) -> torch.Tensor:
    """float32 global norm over dense, SparseRows, Sm3Cover and
    QuantizedRows leaves (quantized leaves are dequantized first, so the
    norm is of the values, not of the int8 payload). Under ``mesh`` the
    dense leaves at the paths of ``split_dims`` are this rank's parts:
    their squares are summed over the axes that cut them (a collective a
    set of axes), the others' counted once. A ``SparseRows`` is the whole
    gradient on every rank unless ``sparse_axes`` names the axes that cut
    its rows (a training step's: ``collectives.data_sum_axes``)."""
    sq, parts = [], {}
    split_dims = split_dims or {}
    for path, g in _named_leaves(grads):
        if g is None:
            continue
        axes = ()
        if sparse_lib.is_sparse(g):
            x = sparse_lib.sq_norm(g)
            axes = tuple(sparse_axes)
        elif isinstance(g, QuantizedRows):
            x = torch.square(compression.dequantize_rows(g)).sum()
        elif isinstance(g, Sm3Cover):
            x = torch.square(g.row.float()).sum() + torch.square(g.col.float()).sum()
        else:
            x = torch.square(g.float()).sum()
            axes = tuple(sorted(ax for ax in split_dims.get(path, ()) if ax))
        (parts.setdefault(axes, []) if axes else sq).append(x)
    total = torch.stack(sq).sum() if sq else None
    for axes, xs in sorted(parts.items()):
        import torch.distributed as dist
        from repro_torch.parallel.sharding import group
        split = torch.stack(xs).sum()
        for ax in axes:
            dist.all_reduce(split, group=group(mesh, ax))
        total = split if total is None else total + split
    return torch.sqrt(total)


def _scaled(grads, s):
    if isinstance(grads, torch.Tensor):
        return grads * s
    if sparse_lib.is_sparse(grads):
        return sparse_lib.scale(grads, s)
    if isinstance(grads, dict):
        return {k: _scaled(g, s) for k, g in grads.items()}
    if hasattr(grads, "_fields"):                  # a NamedTuple (HeadParams)
        return type(grads)(*(_scaled(g, s) for g in grads))
    return type(grads)(_scaled(g, s) for g in grads)


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scl = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return _scaled(grads, scl), norm


def _lazy_horizon(cfg: OptimizerConfig) -> int:
    """Replay depth after which the momentum term is < 1e-9 of its start
    (197 steps at beta1 = 0.9); beyond it the closed-form tail is applied."""
    if cfg.lazy_horizon:
        return int(cfg.lazy_horizon)
    if cfg.beta1 <= 0:
        return 0
    return min(int(math.ceil(math.log(1e-9) / math.log(cfg.beta1))), 1024)


def _rows(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Broadcast a per-row vector against an ndim-rank row block."""
    return x.reshape(x.shape + (1,) * (ndim - x.dim()))


def _adamw_catch_up(cfg: OptimizerConfig, lr_now: float, t: int, p, m, v,
                    last, live=None):
    """Replay the AdamW steps a row missed while untouched.

    A row idle since its step ``last`` missed ``gap = t-1-last`` updates in
    which its gradient was exactly zero but momentum decay, bias
    correction and decoupled weight decay still moved it. Replays the first
    min(gap, horizon) missed steps of every row in one host loop whose trip
    count is the largest gap (one synchronize reads it), then applies the
    closed-form tail for any remainder: by then the momentum term has
    decayed below 1e-9 of its start, so only the pure decay factors
    (b1^extra, b2^extra, (1-lr·wd)^extra) survive. Exact for gap <= the
    horizon; the tail also assumes a constant LR over the skipped range.

    p/m/v fp32 (any rank); ``last`` int32 aligned to axis 0; ``live``
    optionally masks rows out of the replay (a sharded update's clamped
    rows of another rank). Returns (p, m, v) caught up to step t - 1.
    """
    h = _lazy_horizon(cfg)
    gap = torch.clamp(t - 1 - last, min=0)
    if live is not None:
        gap = torch.where(live, gap, torch.zeros_like(gap))
    nd = p.dim()
    n_replay = min(int(gap.max()), h) if gap.numel() else 0
    for j in range(n_replay):
        s = (last + 1 + j).float()                 # absolute step, per row
        on = _rows(j < gap, nd)
        m2 = cfg.beta1 * m
        v2 = cfg.beta2 * v
        bc1 = _rows(1.0 - torch.pow(cfg.beta1, s), nd)
        bc2 = _rows(1.0 - torch.pow(cfg.beta2, s), nd)
        d = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        lr_s = _rows(schedule(cfg, s - 1.0), nd)
        p2 = p - lr_s * (d + cfg.weight_decay * p)
        p, m, v = torch.where(on, p2, p), torch.where(on, m2, m), torch.where(on, v2, v)
    extra = _rows(torch.clamp(gap - h, min=0).float(), nd)
    decay = 1.0 - torch.tensor(lr_now, dtype=torch.float32, device=p.device) * cfg.weight_decay
    m = m * torch.pow(cfg.beta1, extra)
    v = v * torch.pow(cfg.beta2, extra)
    p = p * torch.pow(decay, extra)
    return p, m, v


def _bias_correction(beta: float, t: int) -> float:
    """1 - beta^t with the power in float32, as the JAX package takes it."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(t))


def _leaf_update(cfg: OptimizerConfig, name: str, lr: float, t: int, p, g, m, n):
    """The per-leaf update rule, shared by the dense path (whole tensors)
    and the sparse path (gathered rows): returns (p', m', n'). m/n are fp32
    compute values (already dequantized); ``t`` is the 1-based step; "sm3"
    here is the non-factored case (1-D leaves), which is Adagrad."""
    g32 = g.float()
    m2 = n2 = None
    if name in ("adagrad", "sm3"):
        n2 = n + torch.square(g32)
        u = -lr * g32 / (torch.sqrt(n2) + cfg.eps)
    elif name == "adamw":
        m2 = cfg.beta1 * m + (1 - cfg.beta1) * g32
        n2 = cfg.beta2 * n + (1 - cfg.beta2) * torch.square(g32)
        bc1 = _bias_correction(cfg.beta1, t)
        bc2 = _bias_correction(cfg.beta2, t)
        u = -lr * ((m2 / bc1) / (torch.sqrt(n2 / bc2) + cfg.eps)
                   + cfg.weight_decay * p.float())
    elif name == "sgd":
        u = -lr * g32
    else:
        raise ValueError(name)
    return (p.float() + u).to(p.dtype), m2, n2


def _sm3_dense_update(cfg: OptimizerConfig, lr: float, p, g, cover: Sm3Cover, sd: str,
                      mesh=None, split: Optional[Tuple[Optional[str], ...]] = None):
    """Dense SM3 on a (C, K) table. ν'_ij = min(row_i, col_j) + g²_ij;
    covers take the monotone max with their previous value, which keeps
    them valid upper bounds and makes the sparse path exact (untouched rows
    have ν' <= row_i everywhere, so their cover cannot move).

    ``split``: ``p`` is this rank's part of a table cut over ``mesh``, the
    axis (or None) that cuts each dim. The column cover is whole (the
    reference's placement) and the row cover follows the rows' axis. A
    cover's maximum over a cut dim is partial: the row cover takes an
    ``all_reduce`` MAX over the columns' axis, the column cover over the
    rows' axis and, updated on the rank's columns, over the columns' axis;
    exact since every entry a rank did not update holds its old value,
    which no update lowers."""
    g32 = g.float()
    r = compression.load_rows(cover.row)
    c = cover.col
    rows_ax, cols_ax = split or (None, None)
    cols = slice(0, c.numel())
    if cols_ax:
        from repro_torch.parallel.sharding import rank
        lo = rank(mesh, cols_ax) * p.shape[1]
        cols = slice(lo, lo + p.shape[1])
    nu = torch.minimum(r[:, None], c[None, cols]) + torch.square(g32)
    u = -lr * g32 / (torch.sqrt(nu) + cfg.eps)
    p2 = (p.float() + u).to(p.dtype)
    r2 = torch.maximum(r, nu.amax(dim=1))
    c2 = c.clone()
    c2[cols] = torch.maximum(c[cols], nu.amax(dim=0))
    if rows_ax or cols_ax:
        import torch.distributed as dist
        from repro_torch.parallel.sharding import group
        if rows_ax:
            dist.all_reduce(c2, op=dist.ReduceOp.MAX, group=group(mesh, rows_ax))
        if cols_ax:
            whole = torch.cat([r2, c2])
            dist.all_reduce(whole, op=dist.ReduceOp.MAX, group=group(mesh, cols_ax))
            r2, c2 = whole[:r2.numel()], whole[r2.numel():]
    return p2, Sm3Cover(row=compression.store_rows(r2, _nu_sd(sd)), col=c2)


def _gather_rows(x, ids):
    """fp32 compute rows ``ids`` of a storage leaf (None stays None)."""
    if x is None:
        return None
    if isinstance(x, QuantizedRows):
        return compression.dequantize_rows(
            QuantizedRows(q=x.q.index_select(0, ids), scale=x.scale.index_select(0, ids)))
    return x.index_select(0, ids).float()


def _scatter_rows(x, ids, rows32) -> None:
    """Write fp32 rows into a storage leaf in place, converted to its
    storage (an int8 leaf's rows are quantized with their own scales)."""
    if x is None:
        return
    if isinstance(x, QuantizedRows):
        qr = compression.quantize_rows(rows32)
        x.q.index_copy_(0, ids, qr.q)
        x.scale.index_copy_(0, ids, qr.scale)
    else:
        x.index_copy_(0, ids, rows32.to(x.dtype))


def _sparse_leaf_update(cfg, name, lr, t, ids, p, g, m, n, last) -> None:
    """O(U·K) in-place row update of one leaf touched by a SparseRows
    gradient: gather the rows of the param and of each piece of its state
    (the accumulators, an int8 payload and its per-row scales, the SM3 row
    cover, ``last``), run the dense path's rule on them, write them back
    with ``index_copy_``. The SM3 column cover is a monotone max over the
    touched rows. ``ids`` are unique and in [0, C) (``SparseRows``)."""
    if isinstance(n, Sm3Cover):
        g32 = g.float()
        r = n.row.index_select(0, ids).float()
        nu = torch.minimum(r[:, None], n.col[None, :]) + torch.square(g32)
        u = -lr * g32 / (torch.sqrt(nu) + cfg.eps)
        p.index_copy_(0, ids, (p.index_select(0, ids).float() + u).to(p.dtype))
        n.row.index_copy_(0, ids, torch.maximum(r, nu.amax(dim=1)).to(n.row.dtype))
        if ids.numel():
            torch.maximum(n.col, nu.amax(dim=0), out=n.col)
        return
    p32 = p.index_select(0, ids).float()
    m32, n32 = _gather_rows(m, ids), _gather_rows(n, ids)
    if name == "adamw" and last is not None:
        p32, m32, n32 = _adamw_catch_up(cfg, lr, t, p32, m32, n32,
                                        last.index_select(0, ids))
    p2, m2, n2 = _leaf_update(cfg, name, lr, t, p32, g, m32, n32)
    p.index_copy_(0, ids, p2.to(p.dtype))
    _scatter_rows(m, ids, m2)
    _scatter_rows(n, ids, n2)
    if last is not None:
        last.index_fill_(0, ids, t)


def _sharded_leaf_update(cfg, name, lr, t, ids, p, g, m, n, last, mesh) -> None:
    """:func:`_sparse_leaf_update` on this rank's rows of a row-sharded
    leaf, through ``collectives.sharded_rows_update``: the param and every
    row-indexed piece of its state ride one gather and one owned-rows
    write; SM3's column cover is the one replicated piece."""
    from repro_torch.parallel.collectives import sharded_rows_update
    dense, reps = [p], []
    for x in (m, n):
        if isinstance(x, QuantizedRows):
            dense += [x.q, x.scale]
        elif isinstance(x, Sm3Cover):
            dense.append(x.row)
            reps.append(x.col)
        elif x is not None:
            dense.append(x)
    if last is not None:
        dense.append(last)

    def row_math(rows, vals, reps_in, mine):
        rows = list(rows)
        (gv,) = vals
        g32 = gv.float()
        p32 = rows.pop(0).float()
        if isinstance(n, Sm3Cover):
            r = rows.pop(0).float()
            nu = torch.minimum(r[:, None], reps_in[0][None, :]) + torch.square(g32)
            u = -lr * g32 / (torch.sqrt(nu) + cfg.eps)
            col = reps_in[0].clone()
            if ids.numel():
                own = torch.where(mine[:, None], nu, torch.zeros_like(nu))
                torch.maximum(col, own.amax(dim=0), out=col)
            return [p32 + u, torch.maximum(r, nu.amax(dim=1))], [col]

        def load(x):
            if isinstance(x, QuantizedRows):
                q, scale = rows.pop(0), rows.pop(0)
                return compression.dequantize_rows(QuantizedRows(q=q, scale=scale))
            return None if x is None else rows.pop(0).float()

        m32, n32 = load(m), load(n)
        if name == "adamw" and last is not None:
            p32, m32, n32 = _adamw_catch_up(cfg, lr, t, p32, m32, n32, rows[-1], live=mine)
        p2, m2, n2 = _leaf_update(cfg, name, lr, t, p32, g32, m32, n32)
        out = [p2]
        for x, x2 in ((m, m2), (n, n2)):
            if isinstance(x, QuantizedRows):
                out += list(compression.quantize_rows(x2))
            elif x is not None:
                out.append(x2)
        if last is not None:
            out.append(torch.full_like(rows[-1], t))
        return out, []

    _, new_reps = sharded_rows_update(mesh, row_math, ids, (g,), dense, reps,
                                      with_mask=True)
    if isinstance(n, Sm3Cover):
        n.col.copy_(new_reps[0])


def _dense_leaf_update(cfg, name, sd, lr, t, p, g, m, n, last, mesh=None, split=None):
    """One leaf's dense update; returns new (p, m, n, last). ``split``:
    ``p`` is a rank's part of a leaf, the axis that cuts each dim."""
    if isinstance(n, Sm3Cover):
        p2, n2 = _sm3_dense_update(cfg, lr, p, g, n, sd, mesh, split)
        return p2, m, n2, last
    m32 = compression.load_rows(m) if m is not None else None
    n32 = compression.load_rows(n) if n is not None else None
    p_in = p
    if name == "adamw" and last is not None:
        p_in, m32, n32 = _adamw_catch_up(cfg, lr, t, p.float(), m32, n32, last)
    p2, m2, n2 = _leaf_update(cfg, name, lr, t, p_in, g, m32, n32)
    return (p2.to(p.dtype),
            m if m2 is None else compression.store_rows(m2, sd),
            n if n2 is None else compression.store_rows(n2, _nu_sd(sd)),
            None if last is None else torch.full_like(last, t))


def _assign(dst, src) -> None:
    """Write a leaf's new value into its storage in place (boxes by part)."""
    if dst is None or dst is src:
        return
    if isinstance(dst, _STATE_BOXES):
        for d, s_ in zip(dst, src):
            _assign(d, s_)
    else:
        dst.copy_(src)


def _aligned(tree, n: int):
    """A state tree's leaves (None and boxes kept whole) in the params' order."""
    if tree is None:
        return [None] * n
    leaves = [x for _, x in _named_leaves(tree)]
    if len(leaves) != n:
        raise ValueError(f"optimizer state has {len(leaves)} leaves, the params {n}")
    return leaves


def _apply_tree(cfg: OptimizerConfig, params, grads, state: OptState, lr, t: int,
                mesh=None, split_dims=None) -> None:
    """The update of a tree of params (module docstring), every leaf in
    place; ``grads`` already clipped. Under ``mesh`` the sparse leaves are
    this rank's rows, and the dense ones at the paths of ``split_dims`` its
    parts."""
    split_dims = split_dims or {}
    flat_p = _named_leaves(params)
    n = len(flat_p)
    idx_of = {path: i for i, (path, _) in enumerate(flat_p)}
    rules = _leaf_rules(cfg, [path for path, _ in flat_p])
    ms, ns, ls = (_aligned(x, n) for x in (state.mu, state.nu, state.last))
    covered = set()
    for path, g in _named_leaves(grads):
        if sparse_lib.is_sparse(g):
            # A SparseRows stands in for a {w, b} subtree (2-D w first) or
            # for a bare row table (db None), found by path prefix.
            sub = [i for i, (pp, _) in enumerate(flat_p) if pp[:len(path)] == path]
            if len(sub) == 2:
                if flat_p[sub[0]][1].dim() != 2:
                    sub.reverse()
                pairs = ((sub[0], g.dw), (sub[1], g.db))
            elif len(sub) == 1 and g.db is None:
                pairs = ((sub[0], g.dw),)
            else:
                raise ValueError(f"a SparseRows at {path} must stand for a {{w, b}} "
                                 f"pair or, without db, one table; it covers {len(sub)}")
            for i, gv in pairs:
                _row_update(cfg, rules[sub[0]][0], lr, t, g.ids, flat_p[i][1], gv,
                            ms[i], ns[i], ls[i], mesh)
                covered.add(i)
            continue
        i = idx_of[path]
        name, sd = rules[i]
        p = flat_p[i][1]
        new = _dense_leaf_update(cfg, name, sd, lr, t, p, g, ms[i], ns[i], ls[i], mesh,
                                 split_dims.get(path))
        for dst, src in zip((p, ms[i], ns[i], ls[i]), new):
            _assign(dst, src)
        covered.add(i)
    if len(covered) != n:
        missing = [flat_p[i][0] for i in range(n) if i not in covered]
        raise ValueError(f"grads cover {len(covered)}/{n} param leaves; "
                         f"missing {missing[:5]}")


def _row_update(cfg, name, lr, t, ids, p, g, m, n, last, mesh) -> None:
    if mesh is None:
        _sparse_leaf_update(cfg, name, lr, t, ids, p, g, m, n, last)
    else:
        _sharded_leaf_update(cfg, name, lr, t, ids, p, g, m, n, last, mesh)


def apply_updates(cfg: OptimizerConfig, params, grads, state: OptState,
                  mesh=None, norm: Optional[torch.Tensor] = None, split_dims=None):
    """One optimizer step. Returns (params, state, metrics).

    ``grads`` is a dense ``HeadParams`` or one ``SparseRows`` for the whole
    head. A sparse step writes the touched rows of ``params`` and of the
    state in place and returns those same tensors; a dense step returns new
    ones. A tree of params (module docstring) is updated in place, dense or
    sparse. ``norm``, if given, is ``global_norm(grads)`` computed by the
    caller (a training step reads it before any write) and is not taken
    again.

    ``mesh`` (a ``("data", "model")`` ``DeviceMesh``) makes the sparse
    updates shard-local: the params given are this rank's rows of the
    head (and of the embedding in a tree), the ``SparseRows`` the gradient
    summed over ``data``: the rank's ``model`` slice of the rows in a
    training step with more than one data rank, else whole and replicated
    (module docstring). A dense gradient of a
    standalone head under a mesh raises. ``split_dims`` maps the path of
    each dense leaf that is a rank's part to the axes that cut it (module
    docstring).
    """
    if mesh is not None:
        from repro_torch.parallel.sharding import check_mesh
        check_mesh(mesh)
    name, sd = _rule(cfg)
    metrics = {}
    if cfg.clip_norm:
        norm = global_norm(grads, mesh, split_dims) if norm is None else norm
        grads = _scaled(grads, torch.clamp(cfg.clip_norm / (norm + 1e-12), max=1.0))
        metrics["grad_norm"] = norm
    lr = schedule(cfg, state.step)
    metrics["lr"] = lr
    t = state.step + 1
    if _is_tree(params):
        with torch.no_grad():
            _apply_tree(cfg, params, grads, state, lr, t, mesh, split_dims)
        return params, state._replace(step=t), metrics
    n_leaves = len(params)
    mus, nus, lasts = ((None,) * n_leaves if x is None else x
                       for x in (state.mu, state.nu, state.last))
    with torch.no_grad():
        if sparse_lib.is_sparse(grads):
            for leaf in zip(params, (grads.dw, grads.db), mus, nus, lasts):
                _row_update(cfg, name, lr, t, grads.ids, *leaf, mesh)
            return params, state._replace(step=t), metrics
        if mesh is not None:
            raise ValueError("a row-sharded head takes sparse gradients (SparseRows); "
                             "a dense gradient has no rows to shard")
        out = [_dense_leaf_update(cfg, name, sd, lr, t, *leaf)
               for leaf in zip(params, grads, mus, nus, lasts)]

    def pack(i, old):
        return None if old is None else type(params)(*(o[i] for o in out))

    return (type(params)(*(o[0] for o in out)),
            OptState(step=t, mu=pack(1, state.mu), nu=pack(2, state.nu),
                     last=pack(3, state.last)),
            metrics)


# ---------------------------------------------------------------------------
# Bytes of head state.
# ---------------------------------------------------------------------------

def _is_state_leaf(x) -> bool:
    return x is None or isinstance(x, _STATE_BOXES) or sparse_lib.is_sparse(x)


def _named_leaves(tree):
    """(path, leaf) pairs of a tree of dicts and (named) tuples in sorted-key
    order; a state box, a SparseRows and None are each one leaf."""
    return tree_util.flatten_with_paths(tree, is_leaf=_is_state_leaf)[0]


def _leaf_nbytes(x) -> int:
    """Payload bytes of a state or param leaf (boxes count their parts,
    a Python number such as ``OptState.step`` holds none; works on ``meta``
    tensors, which hold no memory)."""
    if isinstance(x, _STATE_BOXES):
        return sum(_leaf_nbytes(c) for c in x)
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def tree_nbytes(tree) -> int:
    """Total payload bytes of a tree (None leaves free, boxes counted by
    their actual storage: int8 payload + fp32 scales, not fp32)."""
    return sum(_leaf_nbytes(x) for _, x in _named_leaves(tree))


def head_state_bytes(params, state: Optional[OptState]) -> int:
    """Bytes held by the head's params and optimizer state, the state in its
    storage representation. In a tree with a component named "head" only
    the leaves under it count; otherwise every leaf does (a standalone
    head). Build the params and state on ``device="meta"`` to count a head
    that would not fit."""
    flat_p = _named_leaves(params)
    heads = ["head" in path for path, _ in flat_p]
    any_head = any(heads)
    n = len(flat_p)

    def aligned(tree):
        if state is None or tree is None:
            return [None] * n
        leaves = [x for _, x in _named_leaves(tree)]
        assert len(leaves) == n, (len(leaves), n)
        return leaves

    total = 0
    for (_, p), h, m, nu, last in zip(flat_p, heads, aligned(state and state.mu),
                                      aligned(state and state.nu),
                                      aligned(state and state.last)):
        if h or not any_head:
            total += (_leaf_nbytes(p) + _leaf_nbytes(m) + _leaf_nbytes(nu)
                      + _leaf_nbytes(last))
    return total
