"""SparseRows: the O(B·K·n_neg) head-gradient carrier.

A sampled-head training step touches at most ``B·(1 + n_neg)`` rows of the
(C, K) output embedding, yet a dense gradient walks all C rows. ``SparseRows``
stands in for the dense ``{w, b}`` gradient: the deduplicated touched-row
ids and their ``(dw, db)`` sums, so the optimizer applies O(U·K) row updates
(:mod:`repro_torch.optim.optimizers`) and a step costs the same whatever C
is.

Invariants:
  * ``ids`` are unique and in [0, C): PyTorch runs eagerly, so U is the
    number of distinct touched rows, with no fixed size and no sentinel
    slots (the JAX package pads to a static size for its trace);
  * duplicate occurrences (a negative drawn twice, or colliding with the
    positive) are *summed* into one row, so ``to_dense`` equals the dense
    autograd gradient and ``sq_norm`` is the true global-norm contribution;
  * the sums are the same on every run: each row's occurrences are added in
    their original order by ``ops.segment_stats`` (the deterministic CUDA
    kernel on the card, ``index_add_`` in order on the CPU), never by float
    atomics, so a resumed training run replays bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.kernels import ops


class SparseRows(NamedTuple):
    """Sparse row gradient: ``dL/dw[ids] = dw``, ``dL/db[ids] = db``.

    ids: (U,) int64, unique.
    dw:  (U, K) float32 row gradients.
    db:  (U,)   float32 bias gradients, or None for a table without a bias.
    """
    ids: torch.Tensor
    dw: torch.Tensor
    db: Optional[torch.Tensor] = None


def is_sparse(x) -> bool:
    return isinstance(x, SparseRows)


def unique_rows(ids: torch.Tensor, num_rows: int = 0):
    """``torch.unique(ids.reshape(-1), return_inverse=True)`` as int64. On
    fake tensors (the dry run, :mod:`repro_torch.launch.dryrun`) the ids
    are not known, so it gives the bound: every id distinct, up to
    ``num_rows`` rows when that is known (> 0)."""
    ids = ids.reshape(-1).long()
    if device_lib.is_fake(ids):
        n = ids.shape[0]
        u = min(n, num_rows) if num_rows > 0 else n
        return (torch.arange(u, device=ids.device),
                torch.arange(n, device=ids.device) % max(u, 1))
    return torch.unique(ids, return_inverse=True)


def accumulate_rows(ids: torch.Tensor, coeff: torch.Tensor, h: torch.Tensor,
                    num_rows: int) -> SparseRows:
    """Dedupe occurrence-level gradients into per-unique-row sums.

    Per occurrence t the head gradient is a rank-1 term
    ``dL/dw[ids[t]] += coeff[t] * h[t]``, ``dL/db[ids[t]] += coeff[t]``.
    ids: (T,) int (duplicates allowed) in [0, num_rows); coeff: (T,);
    h: (T, K). ``num_rows`` is the row count of the dense table; the result
    has no slot for it. On the card ``torch.unique`` synchronizes the host
    once, to learn U, and the sums' plan once more.
    """
    uniq, inv = unique_rows(ids, num_rows)        # U is dynamic
    coeff = coeff.reshape(-1).float()
    u = uniq.shape[0]
    plan = ops.segment_plan(inv, u)
    db = ops.segment_stats(coeff[:, None], inv, u, plan=plan)[:, 0]
    dw = ops.segment_stats(coeff[:, None] * h.float(), inv, u, plan=plan)
    return SparseRows(ids=uniq, dw=dw, db=db)


def accumulate_embed_rows(ids: torch.Tensor, dh: torch.Tensor,
                          num_rows: int) -> SparseRows:
    """Dedupe per-occurrence embedding gradients into per-row sums.

    The input-embedding gather ``h0 = embed[tokens]`` backpropagates as a
    sum of the gradient rows ``dh`` into the touched token rows: the head's
    computation without the bias and the rank-1 structure. ids: (T,) int
    token ids (duplicates allowed); dh: (T, d) float32 or bfloat16 rows,
    summed in float32. Returns a bias-free ``SparseRows`` (db None) that
    ``optim.apply_updates`` applies to the ``embed`` table.
    """
    uniq, inv = unique_rows(ids, num_rows)        # U is dynamic
    dw = ops.segment_stats(dh.reshape(-1, dh.shape[-1]), inv, uniq.shape[0])
    return SparseRows(ids=uniq, dw=dw, db=None)


def to_dense(sparse: SparseRows, w_shape: Tuple[int, ...]
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Materialize the (C, K) / (C,) dense gradients (tests)."""
    dev = sparse.dw.device
    dw = torch.zeros(w_shape, dtype=torch.float32, device=dev)
    dw.index_add_(0, sparse.ids, sparse.dw)
    if sparse.db is None:
        return dw, None
    db = torch.zeros((w_shape[0],), dtype=torch.float32, device=dev)
    db.index_add_(0, sparse.ids, sparse.db)
    return dw, db


def sq_norm(sparse: SparseRows) -> torch.Tensor:
    """Sum of squares == the dense gradient's (rows are deduped)."""
    sq = torch.square(sparse.dw).sum()
    if sparse.db is not None:
        sq = sq + torch.square(sparse.db).sum()
    return sq


def scale(sparse: SparseRows, s) -> SparseRows:
    return SparseRows(ids=sparse.ids, dw=sparse.dw * s,
                      db=None if sparse.db is None else sparse.db * s)
