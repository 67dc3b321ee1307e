"""Explicit collectives of the sharded model, as
``repro.parallel.collectives`` over ``torch.distributed``.

Every function runs on every rank of the mesh, in SPMD style: each rank
holds its rows of the (V, ...) tables (:mod:`repro_torch.parallel.sharding`)
and the replicated operands whole.

- :func:`sharded_candidate_scores`: the read path. A ``model`` rank scores
  only the candidates it owns (the ``gather_scores`` kernel on the card)
  and one ``all_reduce`` SUM of the small score tensor replicates the
  result; no table is gathered.
- :func:`sharded_rows_update`: the write path. A rank applies the per-row
  optimizer math at the ids it owns and never writes another's; SM3's
  column cover is recombined by ``all_reduce`` MAX.
- :func:`sharded_gather_rows`: the masked local gather + ``all_reduce`` SUM
  that GSPMD lowers the reference's row gathers to (the training head's
  candidate rows, the embedding's token rows), exact since the non-owners
  add zeros.
- :func:`compressed_grad_allreduce`: int8 error-feedback all-reduce over
  ``data``.
- :func:`sum_rows_over_data`, :func:`all_reduce_over_data`, :func:`agree`
  and :func:`broadcast_value`: the data-parallel step's sums and the host
  decisions every rank must take alike.
- :func:`reduce_over_model`, :func:`norm_sum_over_model` and
  :func:`gather_seq_over_model`: the trunk's activations. A row-parallel projection (attention's ``wo``, the MLP's
  and the experts' ``w_down``, the SSM's ``w_out``) leaves each ``model``
  rank a float32 partial sum (:func:`partial_matmul`), reduced in float32
  and rounded once to the model's dtype;
  the attention hint (:mod:`repro_torch.parallel.hints`) leaves each rank
  a part of the sequence, gathered back along it. :data:`TRUNK` counts
  their calls and bytes, and with ``TRUNK.timed`` their host seconds
  (each call then synchronizes the device before and after).

Gloo takes CUDA tensors for every collective used here (checked on the
card), so nothing is staged through the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree_util
from repro_torch.core import heads as heads_lib
from repro_torch.kernels import ops
from repro_torch.optim import compression
from repro_torch.optim.sparse import SparseRows
from repro_torch.parallel import sharding


def _owned(ids: torch.Tensor, n_rows: int, mesh):
    """(local ids clamped into the rank's rows, ownership mask)."""
    lo = sharding.rank(mesh, "model") * n_rows
    local = ids.long() - lo
    mine = (local >= 0) & (local < n_rows)
    return local.clamp(0, n_rows - 1), mine


def sharded_candidate_scores(mesh, w: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
                             ids: torch.Tensor) -> torch.Tensor:
    """xi_ids = w[ids]·h + b[ids] with w (V/tp, K) and b (V/tp,) this rank's
    rows; h (..., K) and ids (..., n) replicated. Returns the (..., n)
    float32 scores on every rank."""
    safe, mine = _owned(ids, w.shape[0], mesh)
    scores = heads_lib.kernel_scores(heads_lib.HeadParams(w=w, b=b), h, safe)
    scores = torch.where(mine, scores, torch.zeros((), dtype=scores.dtype,
                                                   device=scores.device))
    dist.all_reduce(scores, group=sharding.group(mesh, "model"))
    return scores


def sharded_gather_rows(mesh, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``table[ids]`` of a row-sharded table, on every ``model`` rank:
    each rank gathers the ids it owns, zeros the rest, and an
    ``all_reduce`` SUM assembles them. ids (...,) any shape; returns
    ``ids.shape + table.shape[1:]`` in the table's dtype (one nonzero term
    a row, so the sum is exact in any dtype)."""
    safe, mine = _owned(ids, table.shape[0], mesh)
    rows = table.index_select(0, safe.reshape(-1)).reshape(ids.shape + table.shape[1:])
    rows = rows * mine.reshape(mine.shape + (1,) * (table.dim() - 1)).to(rows.dtype)
    dist.all_reduce(rows, group=sharding.group(mesh, "model"))
    return rows


def sharded_rows_update(mesh, fn: Callable, ids: torch.Tensor, vals: Sequence[torch.Tensor],
                        dense_arrays: Sequence[torch.Tensor], rep_arrays=(),
                        with_mask: bool = False):
    """Row-local transform of row-sharded arrays at ``ids``, in place.

    dense_arrays: this rank's rows of (V, ...) arrays (params and
    accumulators), all with the same row count; ids (U,) replicated and
    unique (ids >= V, the reference's sentinel, are dropped); vals: (U, ...)
    replicated per-row values. ``fn(rows, vals) -> new_rows`` is the
    per-row math over every array at once. Each rank gathers the rows at
    its clamped local ids, applies ``fn``, and writes back only the rows it
    owns: non-owned ids gather clamped garbage and are never written.

    With ``rep_arrays`` or ``with_mask``, ``fn`` is called as ``fn(rows,
    vals, reps, mine) -> (new_rows, new_reps)``: ``reps`` are small
    replicated arrays (SM3's column cover) whose new values are recombined
    across ``model`` by ``all_reduce`` MAX, exact for a monotone max, and
    ``mine`` is the (U,) ownership mask ``fn`` must apply to any reduction
    across rows (and to AdamW's catch-up). Returns ``dense_arrays`` (the
    same tensors, updated) and, in the extended form, the new reps.
    """
    n_rows = dense_arrays[0].shape[0]
    if any(d.shape[0] != n_rows for d in dense_arrays):
        raise ValueError("dense arrays must share their row count")
    safe, mine = _owned(ids, n_rows, mesh)
    rows = tuple(d.index_select(0, safe) for d in dense_arrays)
    extended = with_mask or len(rep_arrays)
    if extended:
        new_rows, new_reps = fn(rows, tuple(vals), tuple(rep_arrays), mine)
        new_reps = tuple(new_reps)
        for r in new_reps:
            dist.all_reduce(r, op=dist.ReduceOp.MAX, group=sharding.group(mesh, "model"))
    else:
        new_rows, new_reps = fn(rows, tuple(vals)), ()
    keep = torch.nonzero(mine).reshape(-1)
    dst = safe.index_select(0, keep)
    for d, r in zip(dense_arrays, new_rows):
        d.index_copy_(0, dst, r.index_select(0, keep).to(d.dtype))
    if extended:
        return tuple(dense_arrays), new_reps
    return tuple(dense_arrays)


def compressed_grad_allreduce(mesh, grads: Any, ef: Any) -> Tuple[Any, Any]:
    """int8 error-feedback all-reduce of each rank's own gradients over
    ``data``.

    Each rank quantizes (grad + residual) to int8 with a scale shared over
    ``data`` (an ``all_reduce`` MAX of the amax), so the int8 payloads sum
    exactly as int32; the shared scale dequantizes the sum, divided by the
    replica count. The residual is what quantization dropped, re-injected
    next step. Returns (mean grads, new residuals), each a tree like
    ``grads``.
    """
    g_data = sharding.group(mesh, "data")
    n_rep = sharding.size(mesh, "data")

    def leaf(g, e):
        corrected = g.float() + e
        amax = corrected.abs().max()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g_data)
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.round(corrected / scale).clamp(-127, 127).to(torch.int8)
        q_sum = q.to(torch.int32)
        dist.all_reduce(q_sum, group=g_data)
        mean = q_sum.float() * scale / n_rep
        return mean, corrected - compression._dequantize_leaf(q, scale)

    g_leaves, spec = tree_util.flatten(grads)
    out = [leaf(g, e) for g, e in zip(g_leaves, tree_util.flatten(ef)[0])]
    return (tree_util.unflatten(spec, [m for m, _ in out]),
            tree_util.unflatten(spec, [e for _, e in out]))


def _all_gather_ragged(x: torch.Tensor, g) -> List[torch.Tensor]:
    """Every rank's ``x`` of the group, whose dimension 0 may differ."""
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [torch.empty_like(n) for _ in range(dist.get_world_size(g))]
    dist.all_gather(sizes, n, group=g)
    sizes = [int(s) for s in sizes]
    pad = max(sizes)
    buf = torch.zeros((pad,) + x.shape[1:], dtype=x.dtype, device=x.device)
    buf[:x.shape[0]] = x
    parts = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(parts, buf, group=g)
    return [p[:s] for p, s in zip(parts, sizes)]


def sum_rows_over_data(mesh, rows: SparseRows) -> SparseRows:
    """The sum over ``data`` of each rank's ``SparseRows``: the ids and
    values of every data rank, in rank order, summed per unique id by
    ``segment_stats`` (deterministic, and the same bits on every rank)."""
    if sharding.size(mesh, "data") == 1:
        return rows
    g = sharding.group(mesh, "data")
    ids = torch.cat(_all_gather_ragged(rows.ids, g))
    dw = torch.cat(_all_gather_ragged(rows.dw, g))
    uniq, inv = torch.unique(ids, return_inverse=True)
    plan = ops.segment_plan(inv, uniq.shape[0])
    out_dw = ops.segment_stats(dw, inv, uniq.shape[0], plan=plan)
    out_db = None
    if rows.db is not None:
        db = torch.cat(_all_gather_ragged(rows.db, g))
        out_db = ops.segment_stats(db[:, None], inv, uniq.shape[0], plan=plan)[:, 0]
    return SparseRows(ids=uniq, dw=out_dw, db=out_db)


def all_reduce_over_data(mesh, tensors: Sequence[torch.Tensor]) -> None:
    """SUM each tensor over ``data`` in place, through one flat float32
    buffer (one collective for the whole trunk)."""
    if sharding.size(mesh, "data") == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=sharding.group(mesh, "data"))
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()


def agree(flag: bool, device) -> bool:
    """True on every rank iff it is true on every rank of the world: the
    one outcome all ranks act on after a host event that may differ
    between them (a fit that failed, a preemption signal)."""
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def broadcast_value(value: float, device) -> float:
    """Rank 0's ``value`` on every rank (a clock reading a decision rests on)."""
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.broadcast(t, src=0)
    return float(t.item())


@dataclasses.dataclass
class TrunkCounts:
    """The trunk's ``model`` collectives in this process since the last
    :meth:`reset`."""
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    timed: bool = False

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


TRUNK = TrunkCounts()


def _trunk_call(x: torch.Tensor, fn: Callable[[], None]) -> None:
    TRUNK.calls += 1
    TRUNK.bytes += x.numel() * x.element_size()
    if not TRUNK.timed:
        fn()
        return
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    TRUNK.seconds += time.perf_counter() - t0


def partial_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A row-parallel projection's partial product in float32: ``x @ w``
    for (..., k) @ (k, n), or batched (E, T, k) @ (E, k, n). The products
    are summed in float32 and the result is not rounded to the inputs'
    dtype, so that :func:`reduce_over_model` rounds the sum over ``model``
    once, as a one-rank GEMM rounds its output once. On the card a bf16 pair
    runs as one GEMM writing float32 (``out_dtype``); elsewhere the inputs
    are widened to float32 first, which is exact."""
    if x.dtype == w.dtype == torch.float32:
        return x @ w
    if not x.is_cuda:
        return x.float() @ w.float()
    if w.dim() == 3:
        return torch.bmm(x, w, out_dtype=torch.float32)
    flat = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return flat.reshape(*x.shape[:-1], w.shape[-1])


def reduce_over_model(mesh, partial: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The sum over ``model`` of each rank's float32 partial product
    (B, S, d) (:func:`partial_matmul`), summed in place and rounded once
    to ``dtype``."""
    if partial.dtype != torch.float32:
        raise ValueError(f"a {partial.dtype} partial sum was rounded before its reduction")
    _trunk_call(partial, lambda: dist.all_reduce(partial, group=sharding.group(mesh, "model")))
    return partial.to(dtype)


def gather_seq_over_model(mesh, part: torch.Tensor, seq_dim: int = 1) -> torch.Tensor:
    """Every ``model`` rank's part of the sequence, in rank order, along
    ``seq_dim``: rank r holds positions [r·S/tp, (r+1)·S/tp)."""
    g = sharding.group(mesh, "model")
    buf = part.float().contiguous()      # exact; gloo's types need no bf16
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(g))]
    _trunk_call(buf, lambda: dist.all_gather(parts, buf, group=g))
    return torch.cat(parts, dim=seq_dim).to(part.dtype)


def norm_sum_over_model(mesh, sq_sum: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of each rank's float32 sum of squares
    (B, S, 1): the gated RMSNorm over a dim split across the ranks."""
    total = sq_sum.float()
    _trunk_call(total, lambda: dist.all_reduce(total, group=sharding.group(mesh, "model")))
    return total
