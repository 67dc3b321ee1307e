"""Compressed numeric storage: int8 gradient compression with error
feedback, and quantized optimizer-accumulator storage.

Gradient compression: 8-bit quantization cuts the bytes of a gradient
all-reduce 4x (fp32) / 2x (bf16). Error feedback (Seide et al. 2014;
Karimireddy et al. 2019 "EF-SGD") accumulates the quantization residual
locally and re-injects it next step, preserving convergence.
``compress -> (all-reduce) -> decompress`` is linear, so a quantized
all-reduce equals the all-reduce of the quantized values.

Accumulator storage: at C = 100M labels the (C, K) fp32 optimizer slabs,
not the gradient, are the memory wall. :func:`store_rows` /
:func:`load_rows` convert between fp32 *compute* values and a compact
*storage* representation: plain bf16 tensors (2 bytes an element, ~3
decimal digits, enough for second moments whose only job is a sqrt
denominator), or :class:`QuantizedRows` (int8 payload + fp32 per-row
scale, 1 byte an element). All optimizer math stays fp32; quantization
happens only at the gather/scatter boundary, so it composes with the
sparse O(touched-rows) update path unchanged.

Rounding is half to even (``torch.round``), as in the JAX package.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch


def tree_flatten(tree):
    """The tensor leaves of a tree of dicts, lists, tuples and NamedTuples,
    and a function that builds a tree of the same structure from a list of
    new leaves."""
    if isinstance(tree, dict):
        parts = [tree_flatten(v) for v in tree.values()]

        def build(leaves, keys=list(tree)):
            return dict(zip(keys, _build_parts(parts, leaves)))
    elif isinstance(tree, (list, tuple)):
        parts = [tree_flatten(v) for v in tree]

        def build(leaves, kind=type(tree)):
            out = _build_parts(parts, leaves)
            return kind(*out) if hasattr(kind, "_fields") else kind(out)
    else:
        return [tree], lambda leaves: leaves[0]
    return [x for leaves, _ in parts for x in leaves], build


def _build_parts(parts, leaves):
    out, i = [], 0
    for sub, build in parts:
        out.append(build(leaves[i:i + len(sub)]))
        i += len(sub)
    return out


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (the first's)."""
    flat = [tree_flatten(t)[0] for t in trees]
    return tree_flatten(trees[0])[1]([fn(*xs) for xs in zip(*flat)])


class EFState(NamedTuple):
    error: Any      # residual tree, same structure as the grads


def init_ef_state(grads_like: Any) -> EFState:
    return EFState(error=tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def _quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = g.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(g / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_error_feedback(grads: Any, ef: EFState
                                 ) -> Tuple[Any, Any, EFState]:
    """Returns (q_tree int8, scale_tree, new_ef). The caller all-reduces the
    int8 payload (plus the scalar scales) and divides by the replica count
    after decompression."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, ef.error)
    leaves, build = tree_flatten(corrected)
    qs = [_quantize_leaf(c) for c in leaves]
    q_tree, s_tree = build([q for q, _ in qs]), build([s for _, s in qs])
    new_error = tree_map(lambda c, q, s: c - _dequantize_leaf(q, s),
                         corrected, q_tree, s_tree)
    return q_tree, s_tree, EFState(error=new_error)


def decompress(q_tree: Any, s_tree: Any) -> Any:
    return tree_map(_dequantize_leaf, q_tree, s_tree)


# ---------------------------------------------------------------------------
# Quantized optimizer-state storage (bf16 / int8 + per-row scale).
# ---------------------------------------------------------------------------


class QuantizedRows(NamedTuple):
    """int8 storage for a (C, ...) accumulator: per-row symmetric scale.

    q:     (C, ...) int8 payload.
    scale: (C,) fp32, ``x ≈ q * scale[row]``. Rows of all zeros carry
           scale 1 so dequantization is always well-defined.
    """
    q: torch.Tensor
    scale: torch.Tensor


def is_quantized_rows(x) -> bool:
    return isinstance(x, QuantizedRows)


def _per_row(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    return scale.reshape(scale.shape + (1,) * (ndim - scale.dim()))


def quantize_rows(x: torch.Tensor) -> QuantizedRows:
    """Symmetric per-row (leading-axis) int8 quantization, fp32 in."""
    x32 = x.float()
    amax = x32.abs().amax(dim=tuple(range(1, x32.dim()))) if x32.dim() > 1 else x32.abs()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(x32 / _per_row(scale, x32.dim())).clamp(-127, 127).to(torch.int8)
    return QuantizedRows(q=q, scale=scale)


def dequantize_rows(qr: QuantizedRows) -> torch.Tensor:
    return qr.q.float() * _per_row(qr.scale, qr.q.dim())


def store_rows(x32: torch.Tensor, state_dtype: str) -> Any:
    """fp32 compute value -> storage representation.

    state_dtype: "fp32" (identity), "bf16" (plain bf16 tensor), or "int8"
    (QuantizedRows). 1-D leaves under int8 fall back to bf16: a per-row
    scale on a (C,) vector is a scale per *element*, all cost and no
    compression over bf16.
    """
    if state_dtype == "fp32":
        return x32
    if state_dtype == "bf16" or (state_dtype == "int8" and x32.dim() < 2):
        return x32.to(torch.bfloat16)
    if state_dtype == "int8":
        return quantize_rows(x32)
    raise ValueError(f"unknown state_dtype {state_dtype!r}")


def full_rows(shape, fill: float, state_dtype: str, device) -> Any:
    """``store_rows(torch.full(shape, fill), state_dtype)`` built in its
    storage dtype directly: the fp32 table and the quantizer's temporaries
    would be the largest allocations of an optimizer's init at millions of
    labels."""
    if state_dtype == "fp32":
        return torch.full(shape, fill, dtype=torch.float32, device=device)
    if state_dtype == "bf16" or (state_dtype == "int8" and len(shape) < 2):
        # Through float32, as store_rows rounds: fp32 first, then bf16.
        return torch.full(shape, float(np.float32(fill)), dtype=torch.bfloat16,
                          device=device)
    if state_dtype == "int8" and fill == 0.0:
        return QuantizedRows(q=torch.zeros(shape, dtype=torch.int8, device=device),
                             scale=torch.ones(shape[:1], dtype=torch.float32,
                                              device=device))
    return store_rows(torch.full(shape, fill, dtype=torch.float32, device=device),
                      state_dtype)


def load_rows(x: Any) -> torch.Tensor:
    """Storage representation -> fp32 compute value."""
    if isinstance(x, QuantizedRows):
        return dequantize_rows(x)
    return x.float()
