"""Activation hints, the port of ``repro.parallel.hints``.

Model code takes the hints at the reference's points; with no context
installed every hint returns its input, so one-rank runs are untouched. A
caller installs one with :func:`sharding_hints`; no launcher does, as in
the reference.

In the reference a hint is a sharding constraint that GSPMD lowers. On the
port's explicit ranks it is the work itself:

- :func:`hinted_rows` (the reference's ``hint_attn_q``): where the query
  heads do not divide over ``model``
  (hymba's 25, qwen2-vl's 28, musicgen's 24 at some ``tp``), attention is
  whole on every rank; under the hint rank r takes only the queries
  ``[r·S/tp, (r+1)·S/tp)`` of the sequence (when S divides), so the rank
  computes 1/tp of the logits. The caller reads the keys ``[0,
  cache_pos + b)`` for its queries ``[a, b)``: the kernel aligns queries to
  the end of the keys, so the mask stays the reference's ``q_pos - k_pos``.
- :func:`hint_attn_out`: the output projection's rows of the rank's part,
  all-gathered along the sequence back to (B, S, d).

Training takes the same hint under the plain attention: the rank's query
rows against the keys up to its last one, the masks offset to the rows'
positions. Each rank's gradient of the block's input and of the attention
weights is then a partial sum, summed over ``model`` in the backward pass
(``collectives.copy_to_model``); the gather's gradient is the rank's
slice.

``fsdp_gather_weights`` takes the two FSDP hints:

- :func:`hint_gathered_weight`: the MoE's expert weights gathered over
  ``data`` in ``cfg.dtype`` (each rank casts its part before the gather),
  not in float32: half the FSDP bytes of those leaves. The same bf16
  values reach the same GEMMs and the gradient's sum over ``data`` stays
  float32, so a hinted step is bit-equal to an unhinted one.
- :func:`hint_expert_act`: the identity (its docstring says why).

``seq_parallel_residual`` takes sequence parallelism (the reference's
``hint_residual``, Megatron's): with ``tp`` > 1 model ranks and S dividing
over them, the residual stream (B, S, d) stays split along S between the
blocks, rank r holding the rows :func:`residual_rows` names, so the norms,
the residual adds and each checkpointed layer's saved input are 1/tp a
rank. :func:`hint_residual` cuts the embedding's output to those rows (no
collective). Inside a block (``models/layers.py``, ``moe.py``, ``ssm.py``)
each entry into split weights gathers the rows along S
(``collectives.gather_seq_for_model``, its backward a reduce-scatter), each
row-parallel sum becomes a reduce-scatter along S
(``collectives.scatter_seq_over_model``, its backward a gather), a whole
token-wise branch (an MLP) runs on the rank's rows, and a whole branch
that mixes the sequence runs on the gathered rows and keeps its own: a
whole attention takes :func:`hinted_rows`, which are then the rank's
stream rows, so :func:`hint_attn_out` gathers nothing. After the last
block ``transformer.forward`` gathers the stream back along S
(``collectives.gather_seq_over_model``). Decode (S = 1) and an S that ``tp``
does not divide run as without the hint.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.parallel import collectives, sharding

_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_sharding_hints",
                                                      default=None)


class HintContext:
    """The installed hints on ``mesh``. The reference's ``dp_axes`` and
    ``model_axis`` are fixed to the port's mesh dims, ("data",) and
    "model", and its ``seq_shard_attention`` is always on: no caller asks
    for another value."""

    def __init__(self, mesh, seq_parallel_residual: bool = False,
                 fsdp_gather_weights: bool = False):
        sharding.check_mesh(mesh)
        self.mesh = mesh
        self.seq_parallel_residual = seq_parallel_residual
        self.fsdp_gather_weights = fsdp_gather_weights


@contextlib.contextmanager
def sharding_hints(mesh, seq_parallel_residual: bool = False,
                   fsdp_gather_weights: bool = False):
    tok = _CTX.set(HintContext(mesh, seq_parallel_residual, fsdp_gather_weights))
    try:
        yield
    finally:
        _CTX.reset(tok)


def current() -> Optional[HintContext]:
    return _CTX.get()


@contextlib.contextmanager
def installed(ctx: Optional[HintContext]):
    """Install ``ctx`` (a :func:`current` result, None for none) for the
    block: a checkpointed layer's recompute runs in the backward pass, on
    autograd's thread on the card, which does not see the forward's
    context, so it reinstalls the hints the forward ran under."""
    tok = _CTX.set(ctx)
    try:
        yield
    finally:
        _CTX.reset(tok)


def hinted_rows(num_heads: int, s: int):
    """[a, b) of the S queries this rank takes under the hint, or None: no
    hint installed, one model rank, ``num_heads`` dividing over ``model``
    (the heads are split instead) or S not dividing."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    tp = sharding.size(ctx.mesh, "model")
    if tp == 1 or num_heads % tp == 0 or s % tp != 0:
        return None
    return sharding.row_range(s, ctx.mesh)


def residual_rows(s: int):
    """[a, b) of the S rows of the residual stream this rank holds under
    ``seq_parallel_residual``, or None: no such hint, one model rank, or S
    not dividing (decode's S = 1 among them)."""
    ctx = _CTX.get()
    if ctx is None or not ctx.seq_parallel_residual:
        return None
    tp = sharding.size(ctx.mesh, "model")
    if tp == 1 or s % tp != 0:
        return None
    return sharding.row_range(s, ctx.mesh)


def hint_residual(h: torch.Tensor, rows) -> torch.Tensor:
    """h: the residual stream at a block's entry, ``rows`` the
    :func:`residual_rows` of its full length. A whole (B, S, d) stream (the
    embedding's output, alike on every rank) is cut to the rank's rows; a
    stream already cut, or ``rows`` None, is returned as it is."""
    if rows is None or h.shape[1] == rows[1] - rows[0]:
        return h
    return collectives.split_seq_over_model(_CTX.get().mesh, h)


def hint_gathered_weight(leaf: torch.Tensor, dtype: torch.dtype) -> torch.dtype:
    """The dtype an expert weight's ``data`` part travels in when it is
    gathered (``collectives.gather_over_data``): ``dtype`` (the model's)
    under ``fsdp_gather_weights``, else the leaf's own. The reference's
    hint constrains the cast copy to be replicated over ``data`` so that
    GSPMD gathers it in bf16; the port casts the part inside the gather,
    so the gradient returns to the float32 part unrounded."""
    ctx = _CTX.get()
    return dtype if ctx is not None and ctx.fsdp_gather_weights else leaf.dtype


def hint_expert_act(x: torch.Tensor) -> torch.Tensor:
    """The identity. The reference pins an expert matmul's activation
    (E, tokens, ...) token-sharded over ``data`` so that GSPMD, once the
    hinted weights look replicated over ``data``, does not replicate the
    expert computation on every data rank. On the port's explicit ranks
    each data rank computes only its own tokens already: there is nothing
    to pin and nothing is communicated."""
    return x


def hint_attn_out(out: torch.Tensor, rows) -> torch.Tensor:
    """out: (B, S/tp, d) of the rank's queries ``rows`` back to (B, S, d);
    ``out`` itself where :func:`hinted_rows` gave no part."""
    if rows is None:
        return out
    return collectives.gather_seq_over_model(_CTX.get().mesh, out)

