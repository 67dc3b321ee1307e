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
  add zeros. Under autograd (the dense head and the dense embedding) its
  backward writes the owned rows' gradient into a zero local table and
  sums nothing over ``model``: every rank uses the gathered rows alike,
  so their gradient is whole on every rank. :func:`sum_over_model` is the
  vocab-parallel softmax's sums, whose gradient is the identity for the
  same reason.
- :func:`compressed_grad_allreduce`: int8 error-feedback all-reduce over
  ``data``.
- :func:`sum_rows_over_data`, :func:`all_reduce_over_data`, :func:`agree`
  and :func:`broadcast_value`: the data-parallel step's sums and the host
  decisions every rank must take alike. The sparse rows' sum is by owner:
  each data rank sums a contiguous part of its ``model`` slice of the
  vocabulary (an ``all_to_all`` of the rows there), and the parts are
  gathered back, so a rank holds at most its slice's rows a few times
  over, whatever the number of data ranks; its result is the slice's
  rows, not the whole gradient (:func:`repro_torch.optim.global_norm`
  sums their squares over ``model``).
- :func:`reduce_over_model`, :func:`norm_sum_over_model`,
  :func:`gather_seq_over_model` and :func:`copy_to_model`: the trunk's
  activations, differentiable. A row-parallel projection (attention's
  ``wo``, the MLP's and the experts' ``w_down``, the SSM's ``w_out``)
  leaves each ``model`` rank a float32 partial sum
  (:func:`partial_matmul`), reduced in float32 and rounded once to the
  model's dtype; the attention hint (:mod:`repro_torch.parallel.hints`)
  leaves each rank a part of the sequence, gathered back along it. In the
  backward pass the reduction's gradient is the identity (every rank uses
  the sum alike), the gather's the rank's slice, and the norm's sum and
  :func:`copy_to_model` (the identity forward, where a replicated tensor
  enters work a rank does only in part) sum the partial gradients over
  ``model`` in float32, rounded once. :data:`TRUNK` counts their calls and
  bytes by phase (forward, the recompute under ``cfg.remat``, backward),
  and with ``TRUNK.timed`` their host seconds (each call then
  synchronizes the device before and after).
- :func:`gather_seq_for_model`, :func:`scatter_seq_over_model`,
  :func:`split_seq_over_model` and :func:`gather_seq_over_model`: sequence
  parallelism (the hint ``seq_parallel_residual``,
  :mod:`repro_torch.parallel.hints`), each differentiable and counted in
  :data:`TRUNK`. A block's entry into split weights all-gathers the rank's
  S/tp rows of the stream (its bytes, in the stream's dtype; backward a
  float32 reduce-scatter of the partial gradients, rounded once), a
  row-parallel exit reduce-scatters the float32 partial along S (rounded
  once; backward an all-gather), the embedding's output is cut to the
  rank's rows (no collective; backward an all-gather, so the embedding's
  gradient is whole on every rank) and the stream after the last block is
  gathered for the head (backward the rank's slice: every rank computes
  the head's loss alike). A reduce-scatter counts its whole input's bytes,
  a gather the part the rank sends.
- :func:`gather_over_data`: FSDP. A layer's ``data`` parts gathered in one
  ``all_gather`` over ``data`` through a flat byte buffer (a gather only
  moves bytes, so leaves of any dtype share it, and a bfloat16 copy
  travels as its bytes over gloo), the gradients reduce-scattered back to
  the rank's parts in float32 over ``data``, one ``reduce_scatter`` a
  leaf.
  :data:`FSDP` counts them as :data:`TRUNK` counts the ``model``
  collectives, and the forward's bytes by leaf.

Gloo takes CUDA tensors for every collective used here (checked on the
card), so nothing is staged through the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import device as device_lib
from repro_torch import tree_util
from repro_torch.core import heads as heads_lib
from repro_torch.kernels import ops
from repro_torch.optim import compression
from repro_torch.optim import sparse as sparse_lib
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


def _gather_owned(mesh, table: torch.Tensor, safe, mine, shape) -> torch.Tensor:
    rows = table.index_select(0, safe.reshape(-1)).reshape(shape + table.shape[1:])
    rows = rows * mine.reshape(mine.shape + (1,) * (table.dim() - 1)).to(rows.dtype)
    dist.all_reduce(rows, group=sharding.group(mesh, "model"))
    return rows


class _ShardedGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mesh):
        safe, mine = _owned(ids, table.shape[0], mesh)
        ctx.save_for_backward(safe, mine)
        ctx.table_shape = table.shape
        return _gather_owned(mesh, table, safe, mine, ids.shape)

    @staticmethod
    def backward(ctx, g):
        safe, mine = ctx.saved_tensors
        rows = g.reshape((-1,) + tuple(ctx.table_shape[1:]))
        rows = rows * mine.reshape((-1,) + (1,) * (rows.dim() - 1)).to(rows.dtype)
        out = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        return out.index_add_(0, safe.reshape(-1), rows), None, None


def sharded_gather_rows(mesh, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``table[ids]`` of a row-sharded table, on every ``model`` rank:
    each rank gathers the ids it owns, zeros the rest, and an
    ``all_reduce`` SUM assembles them. ids (...,) any shape; returns
    ``ids.shape + table.shape[1:]`` in the table's dtype (one nonzero term
    a row, so the sum is exact in any dtype). Under autograd the table's
    gradient is the rows' gradient added at the owned ids of a zero local
    table: nothing is summed over ``model``, since every rank uses the rows
    alike (module docstring)."""
    if _tracked(table):
        return _ShardedGatherRows.apply(table, ids, mesh)
    safe, mine = _owned(ids, table.shape[0], mesh)
    return _gather_owned(mesh, table, safe, mine, ids.shape)


def _summed_over_model(mesh, x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=sharding.group(mesh, "model"))
    return out


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _summed_over_model(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_model(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of each rank's ``x`` (a new tensor). Under
    autograd its gradient is the identity: every rank uses the sum alike,
    so each rank's term takes the sum's gradient."""
    if _tracked(x):
        return _SumOverModel.apply(x, mesh)
    return _summed_over_model(mesh, x)


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
    # The rows this rank owns; on fake tensors (the dry run) the bound: all.
    keep = (torch.arange(mine.shape[0], device=mine.device) if device_lib.is_fake(mine)
            else torch.nonzero(mine).reshape(-1))
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


def _gather_ragged(xs: Sequence[torch.Tensor], g) -> List[torch.Tensor]:
    """Every rank's tensors of the group, concatenated in rank order: each
    of ``xs`` has the same dimension 0 on a rank, which may differ between
    ranks (one ``all_gather`` of the sizes, then one a tensor, padded to the
    largest)."""
    n = torch.tensor([xs[0].shape[0]], dtype=torch.int64, device=xs[0].device)
    sizes = [torch.empty_like(n) for _ in range(dist.get_world_size(g))]
    dist.all_gather(sizes, n, group=g)
    # Fake tensors (the dry run) hold no sizes: every rank's is this one's.
    sizes = [xs[0].shape[0] if device_lib.is_fake(s) else int(s) for s in sizes]
    pad = max(sizes)
    out = []
    for x in xs:
        if pad == 0:
            out.append(x)
            continue
        buf = torch.zeros((pad,) + x.shape[1:], dtype=x.dtype, device=x.device)
        buf[:x.shape[0]] = x
        parts = [torch.empty_like(buf) for _ in sizes]
        dist.all_gather(parts, buf, group=g)
        del buf
        out.append(torch.cat([p[:s] for p, s in zip(parts, sizes)]))
    return out


def _exchange(x: torch.Tensor, send: List[int], recv: List[int], g) -> torch.Tensor:
    """Rows ``x`` cut into ``send[r]`` rows for data rank r, in order; returns
    the ``recv[r]`` rows from each rank r, in rank order."""
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes=recv, input_split_sizes=send, group=g)
    return out


def data_sum_plan(n_ids: int, n_rows: int, dp: int) -> Tuple[int, int, int]:
    """The dry run's bound for :func:`sum_rows_over_data` (the data decide
    it on the card): every id of a rank's ``n_ids`` distinct and in its
    slice, so it keeps ``own`` rows; each owner of ``sub`` rows receives at
    most ``sub`` from each data rank, sums them to at most ``sub``, and
    the union is dp of those. Returns (own, received, union) rows."""
    sub = -(-n_rows // dp)
    own = min(n_ids, n_rows)
    received = dp * min(own, sub)
    return own, received, dp * min(received, sub)


def data_sum_axes(mesh) -> Tuple[str, ...]:
    """The axes that cut :func:`sum_rows_over_data`'s result across the
    ranks of ``mesh`` (None: no mesh): ``model`` where both axes have more
    than one rank. With one data rank the rows come back whole; with one
    model rank the slice is the whole table."""
    if mesh is None or sharding.size(mesh, "data") == 1 or sharding.size(mesh, "model") == 1:
        return ()
    return ("model",)


@dataclasses.dataclass
class RowSums:
    """The last sum over ``data`` in this process (None before the first):
    the rows it ``kept``, ``received`` and summed into the ``union``;
    ``db``, 1 where the rows carry one (the owner calls ``segment_stats``
    for ``dw`` and for ``db``, and for neither when it received no row);
    their ``bytes`` (ids, ``dw``, ``db``); and ``bound_bytes``, the same
    for the kept rows and twice dp · ceil(n_rows / dp) rows, about twice
    the slice whatever dp is. A caller that wants every call's record
    reads it after each one."""
    last: Optional[Dict[str, int]] = None


ROW_SUMS = RowSums()


def sum_rows_over_data(mesh, rows: SparseRows, n_rows: int) -> SparseRows:
    """The sum over ``data`` of each rank's ``SparseRows``, cut to this
    rank's ``model`` slice of the table (global ids in [lo, lo + n_rows),
    ``n_rows`` the rows each ``model`` rank holds), the same ids and bits
    on every data rank of the slice.

    1. keep the rows in the slice (the only ones ``sharded_rows_update``
       writes here), sorted by id;
    2. owner d of ``data`` takes the slice's d-th of dp contiguous parts:
       one ``all_to_all`` of the per-owner counts, then one of the ids, the
       ``dw`` and the ``db`` rows, so each owner receives its part's rows
       from every data rank, in rank order;
    3. the owner sums them per unique id by ``segment_stats``. A segment's
       sum depends only on its rows and their order, and every rank's rows
       are deduped, so this is bit for bit the sum of every data rank's
       rows concatenated in rank order (the gather-everything sum), cut to
       the slice;
    4. the owners' sums are gathered over ``data`` in rank order: the
       slice's ids, sorted.

    A rank sends each owner at most n_rows / dp deduped rows, so it holds
    at most its own kept rows, about n_rows received rows and the
    n_rows-row union, whatever dp is (:data:`ROW_SUMS` keeps the last
    call's record beside that bound). With one data rank the rows are
    returned as they are, whole (:func:`data_sum_axes`). On fake tensors
    (the dry run) the sizes are the bound of :func:`data_sum_plan`.
    """
    dp = sharding.size(mesh, "data")
    if dp == 1:
        return rows
    g = sharding.group(mesh, "data")
    lo = sharding.rank(mesh, "model") * n_rows
    sub = -(-n_rows // dp)
    dev = rows.ids.device
    if device_lib.is_fake(rows.ids):
        own, n_recv, _ = data_sum_plan(rows.ids.shape[0], n_rows, dp)
        keep = torch.arange(own, device=dev)
        send = [min(sub, max(0, own - d * sub)) for d in range(dp)]
        recv = [n_recv // dp] * dp
        counts = torch.zeros((dp,), dtype=torch.int64, device=dev)
    else:
        local = rows.ids.long() - lo
        keep = torch.nonzero((local >= 0) & (local < n_rows)).reshape(-1)
        local, order = torch.sort(local.index_select(0, keep))
        keep = keep.index_select(0, order)
        counts = torch.bincount(torch.div(local, sub, rounding_mode="floor"), minlength=dp)
    counts_in = torch.empty_like(counts)
    dist.all_to_all_single(counts_in, counts, group=g)
    if not device_lib.is_fake(rows.ids):
        send, recv = torch.stack([counts, counts_in]).tolist()
    ids = _exchange(rows.ids.index_select(0, keep), send, recv, g)
    dw = _exchange(rows.dw.index_select(0, keep), send, recv, g)
    db = None if rows.db is None else _exchange(rows.db.index_select(0, keep), send, recv, g)
    uniq, inv = sparse_lib.unique_rows(ids, sub)
    u = uniq.shape[0]
    plan = ops.segment_plan(inv, u)
    parts = [uniq, ops.segment_stats(dw, inv, u, plan=plan)]
    del dw
    if db is not None:
        parts.append(ops.segment_stats(db[:, None], inv, u, plan=plan)[:, 0])
    del ids, db, inv, plan
    out = _gather_ragged(parts, g)
    row_bytes = 8 + 4 * (rows.dw.shape[1] + (rows.db is not None))
    held = (keep.shape[0], sum(recv), out[0].shape[0])
    ROW_SUMS.last = dict(
        kept=held[0], received=held[1], union=held[2], db=int(rows.db is not None),
        bytes=sum(held) * row_bytes,
        bound_bytes=(min(rows.ids.shape[0], n_rows) + 2 * dp * sub) * row_bytes)
    return SparseRows(ids=out[0], dw=out[1], db=out[2] if rows.db is not None else None)


def all_reduce_over_data(mesh, tensors: Sequence[torch.Tensor]) -> None:
    """SUM each tensor over ``data`` in place, through one flat float32
    buffer (one collective for the whole trunk); one contiguous float32
    tensor (a dense head's or embedding's gradient) is summed where it
    lies, with no staging copy."""
    if sharding.size(mesh, "data") == 1 or not tensors:
        return
    if len(tensors) == 1 and tensors[0].dtype == torch.float32 \
            and tensors[0].is_contiguous():
        dist.all_reduce(tensors[0], group=sharding.group(mesh, "data"))
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


PHASES = ("forward", "recompute", "backward")


def _phase_counts() -> Dict[str, Dict[str, float]]:
    return {p: {"calls": 0, "bytes": 0, "seconds": 0.0} for p in PHASES}


@dataclasses.dataclass
class TrunkCounts:
    """The trunk's collectives of one kind in this process since the last
    :meth:`reset`: in all, and by phase (``phases``): the forward, its
    recompute in the backward pass (the checkpointed layers reissue their
    forward collectives, :func:`recomputing`), and the backward's own.
    ``leaves``: the forward's bytes by leaf name (FSDP's gathers)."""
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    timed: bool = False
    phases: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=_phase_counts)
    phase: str = "forward"
    leaves: Dict[str, int] = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0
        self.phases = _phase_counts()
        self.leaves = {}


TRUNK = TrunkCounts()           # the model collectives
FSDP = TrunkCounts()            # the data gathers and reduce-scatters


@contextlib.contextmanager
def recomputing():
    """Count the collectives issued inside as the recompute's: the context
    ``torch.utils.checkpoint`` enters around a layer's recomputed forward."""
    before = TRUNK.phase, FSDP.phase
    TRUNK.phase = FSDP.phase = "recompute"
    try:
        yield
    finally:
        TRUNK.phase, FSDP.phase = before


def _trunk_call(x: torch.Tensor, fn: Callable[[], None], phase: Optional[str] = None,
                kind: TrunkCounts = TRUNK) -> None:
    n = x.numel() * x.element_size()
    counts = kind.phases[phase or kind.phase]
    kind.calls += 1
    kind.bytes += n
    counts["calls"] += 1
    counts["bytes"] += n
    if not kind.timed:
        fn()
        return
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    dt = time.perf_counter() - t0
    kind.seconds += dt
    counts["seconds"] += dt


def _tracked(x: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``x`` here."""
    return torch.is_grad_enabled() and x.requires_grad


def _sum_grad(mesh, g: torch.Tensor) -> torch.Tensor:
    """The backward's sum over ``model`` of a partial gradient: in float32
    (gloo has no bfloat16), rounded once to the gradient's dtype. The
    incoming gradient is never written."""
    buf = g.to(torch.float32, copy=True).contiguous()
    _trunk_call(buf, lambda: dist.all_reduce(buf, group=sharding.group(mesh, "model")),
                "backward")
    return buf.to(g.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_grad(ctx.mesh, g), None


def copy_to_model(mesh, x: torch.Tensor) -> torch.Tensor:
    """The identity, whose gradient is summed over ``model``: where a
    replicated tensor enters work that each rank does only in part (a
    block's input before its split weights, a whole leaf a rank reads only
    in part), each rank's gradient of it is a partial sum. Outside autograd
    (or on one model rank) it returns ``x``."""
    if mesh is None or sharding.size(mesh, "model") == 1 or not _tracked(x):
        return x
    return _CopyToModel.apply(x, mesh)


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One GEMM of a bf16 pair on the card writing float32 (``out_dtype``):
    (T, k) @ (k, n), or batched (E, T, k) @ (E, k, n)."""
    if w.dim() == 3:
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.mm(x, w, out_dtype=torch.float32)


class _PartialMatmul(torch.autograd.Function):
    """:func:`_mm_f32` under autograd (``out_dtype`` has no derivative). The
    backward is a one-rank bf16 GEMM's: the output's gradient rounded to
    the inputs' dtype, then ``g @ wᵀ`` and ``xᵀ @ g`` in that dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.transpose(-1, -2), x.transpose(-1, -2) @ g


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
    if not device_lib.on_card(x):
        return x.float() @ w.float()
    gemm = _PartialMatmul.apply if _tracked(x) or _tracked(w) else _mm_f32
    if w.dim() == 3:
        return gemm(x, w)
    # Reshaped outside the GEMM: the sum over model writes its result in place.
    return gemm(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[-1])


def _all_reduce_model(mesh, x: torch.Tensor) -> None:
    _trunk_call(x, lambda: dist.all_reduce(x, group=sharding.group(mesh, "model")))


class _ReduceOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, partial, mesh):
        _all_reduce_model(mesh, partial)
        ctx.mark_dirty(partial)
        return partial

    @staticmethod
    def backward(ctx, g):
        return g, None          # the sum is used alike on every rank


def reduce_over_model(mesh, partial: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The sum over ``model`` of each rank's float32 partial product
    (B, S, d) (:func:`partial_matmul`), summed in place and rounded once
    to ``dtype``. Its gradient is the identity: every rank uses the sum
    alike, so each partial's gradient is the sum's."""
    if partial.dtype != torch.float32:
        raise ValueError(f"a {partial.dtype} partial sum was rounded before its reduction")
    if _tracked(partial):
        return _ReduceOverModel.apply(partial, mesh).to(dtype)
    _all_reduce_model(mesh, partial)
    return partial.to(dtype)


# ---------------------------------------------------------------------------
# Sequence parallelism over ``model`` (the hint ``seq_parallel_residual``)
# ---------------------------------------------------------------------------

def _gather_seq_bytes(mesh, part: torch.Tensor, phase: Optional[str] = None) -> torch.Tensor:
    """Every ``model`` rank's (B, S/tp, ...) part along dim 1, in rank
    order: one ``all_gather`` of the parts' bytes (a gather only moves
    bytes, so a bfloat16 stream travels in its own width over gloo)."""
    g = sharding.group(mesh, "model")
    buf = part.contiguous().view(torch.uint8)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(g))]
    _trunk_call(buf, lambda: dist.all_gather(parts, buf, group=g), phase)
    return torch.cat(parts, dim=1).view(part.dtype)


def _scatter_seq_f32(mesh, full: torch.Tensor, phase: Optional[str] = None) -> torch.Tensor:
    """The sum over ``model`` of each rank's float32 (B, S, ...), each rank
    keeping its rows along dim 1: one ``reduce_scatter``, counted at the
    whole input's bytes. The incoming tensor is never written."""
    g = sharding.group(mesh, "model")
    full = full.float()
    chunks = [c.contiguous() for c in full.chunk(dist.get_world_size(g), dim=1)]
    out = torch.empty_like(chunks[0])
    _trunk_call(full, lambda: dist.reduce_scatter(out, chunks, group=g), phase)
    return out


class _GatherSeqForModel(torch.autograd.Function):
    """Forward: the rank's rows of the stream gathered along S. Backward:
    the gathered input's gradient on a rank is PARTIAL (its heads', its
    ``d_ff``'s or its experts' share, over every row), so the true gradient
    of the rank's rows is the sum over ``model`` of every rank's at those
    rows: a reduce-scatter along S in float32, rounded once."""

    @staticmethod
    def forward(ctx, part, mesh):
        ctx.mesh = mesh
        return _gather_seq_bytes(mesh, part)

    @staticmethod
    def backward(ctx, g):
        return _scatter_seq_f32(ctx.mesh, g, "backward").to(g.dtype), None


def gather_seq_for_model(mesh, part: torch.Tensor) -> torch.Tensor:
    """Under sequence parallelism, a block's entry into split weights (or
    into a whole branch that mixes the sequence): the rank's (B, S/tp, d)
    rows of the stream gathered to (B, S, d). Its backward reduce-scatters
    the partial gradients (see :class:`_GatherSeqForModel`); it takes the
    place of :func:`copy_to_model` on the block's input."""
    if _tracked(part):
        return _GatherSeqForModel.apply(part, mesh)
    return _gather_seq_bytes(mesh, part)


class _ScatterSeqOverModel(torch.autograd.Function):
    """Forward: each rank's float32 partial (B, S, d) summed over ``model``,
    the rank keeping its S/tp rows. Backward: the gradient of the rank's
    rows is WHOLE (the stream's rows are used by this rank alone), and a
    partial's gradient is the sum's at every row, so the rows' gradients
    are all-gathered along S."""

    @staticmethod
    def forward(ctx, partial, mesh):
        ctx.mesh = mesh
        return _scatter_seq_f32(mesh, partial)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq_bytes(ctx.mesh, g, "backward"), None


def scatter_seq_over_model(mesh, partial: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Under sequence parallelism, a row-parallel projection's exit: the
    float32 partial (B, S, d) reduce-scattered along S to the rank's
    (B, S/tp, d) rows and rounded once to ``dtype`` (as
    :func:`reduce_over_model` rounds the whole sum once)."""
    if partial.dtype != torch.float32:
        raise ValueError(f"a {partial.dtype} partial sum was rounded before its reduction")
    if _tracked(partial):
        return _ScatterSeqOverModel.apply(partial, mesh).to(dtype)
    return _scatter_seq_f32(mesh, partial).to(dtype)


def row_parallel_sum(mesh, partial: torch.Tensor, dtype: torch.dtype,
                     seq: bool = False) -> torch.Tensor:
    """A row-parallel projection's float32 partials summed over ``model``
    and rounded once to ``dtype``: whole on every rank
    (:func:`reduce_over_model`), or under sequence parallelism (``seq``)
    reduce-scattered to the rank's rows (:func:`scatter_seq_over_model`)."""
    if seq:
        return scatter_seq_over_model(mesh, partial, dtype)
    return reduce_over_model(mesh, partial, dtype)


class _SplitSeq(torch.autograd.Function):
    """Forward: the rank's rows of a (B, S, d) tensor every rank holds
    alike (the embedding's output). Backward: each rank's gradient is
    nonzero only at its rows, and the whole tensor's gradient (which the
    sparse embedding's rows and the dense embedding's table read on every
    rank) is those rows all-gathered along S."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        lo, hi = sharding.row_range(x.shape[1], mesh)
        return x[:, lo:hi].clone()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq_bytes(ctx.mesh, g, "backward"), None


def split_seq_over_model(mesh, x: torch.Tensor) -> torch.Tensor:
    """The rank's rows ``sharding.row_range(S, mesh)`` of a (B, S, ...)
    tensor held alike on every ``model`` rank: no collective forward, an
    all-gather of the gradient backward."""
    if _tracked(x):
        return _SplitSeq.apply(x, mesh)
    lo, hi = sharding.row_range(x.shape[1], mesh)
    return x[:, lo:hi]


class _GatherSeq(torch.autograd.Function):
    """Forward: every ``model`` rank's part gathered along S. Backward:
    every rank uses the gathered whole alike (a hinted attention's output;
    under sequence parallelism the stream after the last block, from which
    every rank computes the head's whole loss), so each rank's gradient of
    it is WHOLE and the part's gradient is the rank's slice; a
    reduce-scatter here would count it tp times."""

    @staticmethod
    def forward(ctx, part, mesh):
        ctx.mesh, ctx.n = mesh, part.shape[1]
        return _gather_seq_bytes(mesh, part)

    @staticmethod
    def backward(ctx, g):
        lo = sharding.rank(ctx.mesh, "model") * ctx.n
        return g[:, lo:lo + ctx.n], None


def gather_seq_over_model(mesh, part: torch.Tensor) -> torch.Tensor:
    """Every ``model`` rank's (B, S/tp, ...) part of the sequence, in rank
    order, as (B, S, ...): rank r holds positions [r·S/tp, (r+1)·S/tp). The
    gradient of a rank's part is its slice of the whole's (see
    :class:`_GatherSeq`)."""
    if _tracked(part):
        return _GatherSeq.apply(part, mesh)
    return _gather_seq_bytes(mesh, part)


class _NormSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sq_sum, mesh):
        ctx.mesh = mesh
        total = sq_sum.to(torch.float32, copy=True)
        _all_reduce_model(mesh, total)
        return total

    @staticmethod
    def backward(ctx, g):
        # Each rank scales only its own columns by the total, so the total's
        # gradient on a rank is partial: the transpose sums it.
        return _sum_grad(ctx.mesh, g), None


def norm_sum_over_model(mesh, sq_sum: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of each rank's float32 sum of squares
    (B, S, 1): the gated RMSNorm over a dim split across the ranks. Its
    gradient is summed over ``model`` too: each rank uses the total only
    for its own columns."""
    if _tracked(sq_sum):
        return _NormSum.apply(sq_sum, mesh)
    total = sq_sum.float()
    _all_reduce_model(mesh, total)
    return total


# ---------------------------------------------------------------------------
# FSDP over ``data``
# ---------------------------------------------------------------------------

_ALIGN = 16          # bytes: every leaf's slice of the flat buffer starts aligned


def _aligned(n: int) -> int:
    return n + (-n % _ALIGN)


def _gather_parts(mesh, parts: Sequence[torch.Tensor], dims: Sequence[int],
                  names: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """Every ``data`` rank's part of each leaf, joined along its dim: one
    ``all_gather`` of the parts' bytes through a flat buffer."""
    g = sharding.group(mesh, "data")
    flat = torch.zeros(sum(_aligned(p.numel() * p.element_size()) for p in parts),
                       dtype=torch.uint8, device=parts[0].device)
    off = 0
    for i, p in enumerate(parts):
        n = p.numel() * p.element_size()
        flat[off:off + n].copy_(p.contiguous().reshape(-1).view(torch.uint8))
        if names is not None and FSDP.phase == "forward":
            FSDP.leaves[names[i]] = FSDP.leaves.get(names[i], 0) + n
        off += _aligned(n)
    out = flat.new_empty(dist.get_world_size(g) * flat.numel())
    _trunk_call(flat, lambda: dist.all_gather_into_tensor(out, flat, group=g), kind=FSDP)
    out = out.view(-1, flat.numel())
    del flat                         # the rank's bytes are in ``out`` now
    full, off = [], 0
    for p, dim in zip(parts, dims):
        n = p.numel() * p.element_size()
        full.append(torch.cat([o[off:off + n].view(p.dtype).view(p.shape) for o in out],
                              dim=dim))
        off += _aligned(n)
    return full


class _GatherOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dims, dtypes, names, *parts):
        ctx.mesh, ctx.dims = mesh, dims
        ctx.parts = [(p.shape, p.dtype) for p in parts]
        return tuple(_gather_parts(mesh, [p.to(dt) for p, dt in zip(parts, dtypes)],
                                   dims, names))

    @staticmethod
    def backward(ctx, *grads):
        g = sharding.group(ctx.mesh, "data")
        dp = dist.get_world_size(g)
        out = []
        for gr, dim, (shape, dtype) in zip(grads, ctx.dims, ctx.parts):
            # Rank r's chunk, read where it lies (a leaf cut on dim 0) or
            # copied out of it; no buffer of the whole layer's gradients.
            chunks = [c.contiguous() for c in gr.float().chunk(dp, dim)]
            recv = chunks[0].new_empty(shape)
            _trunk_call(recv, lambda: dist.reduce_scatter(recv, chunks, group=g), "backward",
                        FSDP)
            out.append(recv.to(dtype))
        return (None, None, None, None) + tuple(out)


def gather_over_data(mesh, parts: Sequence[torch.Tensor], dims: Sequence[int],
                     dtypes: Optional[Sequence[torch.dtype]] = None,
                     names: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
    """FSDP's gather of one layer: each of ``parts`` (a rank's ``data``
    part of a leaf, cut along ``dims``) joined with every data rank's, in
    rank order, by one ``all_gather`` over ``data`` (module docstring).
    ``dtypes``: the dtype each part travels in, cast on the rank's part
    before the gather (the hint ``fsdp_gather_weights``; default its own).
    ``names`` label the forward's bytes in ``FSDP.leaves``.

    Under autograd the backward reduce-scatters each full leaf's gradient
    over ``data`` in float32 to the rank's part, returned in the part's
    dtype: one ``reduce_scatter`` a leaf, reading each rank's chunk where
    it lies, so that no buffer of the whole layer's gradients sits beside
    them; every rank's part comes back already summed over the data
    ranks."""
    dtypes = list(dtypes) if dtypes is not None else [p.dtype for p in parts]
    if any(_tracked(p) for p in parts):
        return list(_GatherOverData.apply(mesh, tuple(dims), tuple(dtypes),
                                          None if names is None else tuple(names), *parts))
    return _gather_parts(mesh, [p.to(dt) for p, dt in zip(parts, dtypes)], dims, names)
