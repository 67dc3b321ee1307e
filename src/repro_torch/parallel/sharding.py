"""Placement of the vocab-sharded head on a ``("data", "model")`` mesh, as
the head's part of ``repro.parallel.sharding``.

The port runs one process per rank and holds plain local tensors (no
``DTensor``: every kernel would have to unwrap one). The embedding and the
head are ``P("model", None)`` in the reference: a ``model`` rank owns the
contiguous rows ``[r·V/tp, (r+1)·V/tp)`` of each, and so of every
row-indexed piece of their optimizer state (the accumulators, an int8
payload and its per-row scales, SM3's row cover, lazy AdamW's ``last``).
SM3's column cover, the step counters, the generator state and the trunk
stay whole on every rank. The batch is split over ``data``.

:func:`shard_train_state` and :func:`gather_train_state` convert between
the full state (a one-rank run's, a checkpoint's, or one carried across
from the JAX package by :mod:`repro_torch.convert`) and a rank's local
state; gathering is a collective over ``model``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch import tree_util

MESH_DIMS = ("data", "model")
ROW_SHARDED = ("embed", "head")      # the P("model", None) leaves


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a ``DeviceMesh`` with dims ("data", "model")."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh.DeviceMesh with "
                        f"dims {MESH_DIMS}, got {type(mesh).__name__}")
    if tuple(mesh.mesh_dim_names or ()) != MESH_DIMS:
        raise ValueError(f"mesh dims must be {MESH_DIMS}, got {mesh.mesh_dim_names}")


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """(data axes, model axis), as the reference's ``mesh_axes``."""
    check_mesh(mesh)
    return MESH_DIMS[:-1], MESH_DIMS[-1]


def group(mesh, dim: str):
    return mesh.get_group(dim)


def size(mesh, dim: str) -> int:
    return mesh.shape[MESH_DIMS.index(dim)]


def rank(mesh, dim: str) -> int:
    return mesh.get_local_rank(dim)


def row_range(n_rows: int, mesh) -> Tuple[int, int]:
    """[lo, hi) of the rows this rank owns of an ``n_rows`` table sharded
    over ``model``: contiguous ranges of n_rows / tp rows."""
    tp = size(mesh, "model")
    if n_rows % tp:
        raise ValueError(f"{n_rows} rows do not divide over {tp} model ranks")
    n = n_rows // tp
    lo = rank(mesh, "model") * n
    return lo, lo + n


def shard_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a full table (a copy that owns its storage)."""
    lo, hi = row_range(x.shape[0], mesh)
    return x[lo:hi].clone()


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The full table from every ``model`` rank's rows (a collective)."""
    g = group(mesh, "model")
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, x.contiguous(), group=g)
    return torch.cat(parts, dim=0)


def batch_slice(n: int, mesh) -> slice:
    """The batch rows this rank takes: its slice over ``data`` when ``n``
    divides, else all of them (the reference replicates such a batch)."""
    dp = size(mesh, "data")
    if n % dp:
        return slice(0, n)
    per = n // dp
    r = rank(mesh, "data")
    return slice(r * per, (r + 1) * per)


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's part of a global batch, as ``batch_shardings`` places it:
    dimension 0 over ``data``, ``positions`` (3, B, S) on dimension 1."""
    out = {}
    for key, x in batch.items():
        if key == "positions" and x.dim() == 3:
            out[key] = x[:, batch_slice(x.shape[1], mesh)]
        elif x.dim() == 0:
            out[key] = x
        else:
            out[key] = x[batch_slice(x.shape[0], mesh)]
    return out


def is_row_path(path: Tuple[str, ...]) -> bool:
    """Whether the leaf at ``path`` of a params tree, an optimizer state
    tree or a ``TrainState`` is row-sharded: under ``embed`` or ``head``,
    not SM3's column cover."""
    if path[:1] == ("params",):
        path = path[1:]
    elif path[:1] == ("opt_state",):
        if len(path) < 2 or path[1] not in ("mu", "nu", "last"):
            return False
        path = path[2:]
    elif path[:1] in (("mu",), ("nu",), ("last",)):
        path = path[1:]
    return bool(path) and path[0] in ROW_SHARDED and path[-1] != "col"


def _map_rows(tree, fn, is_row=is_row_path):
    pairs, spec = tree_util.flatten_with_paths(tree)
    return tree_util.unflatten(spec, [
        fn(x) if isinstance(x, torch.Tensor) and x.dim() and is_row(p) else x
        for p, x in pairs])


def _head_row(path: Tuple[str, ...]) -> bool:
    return path[-1:] != ("col",)


def shard_train_state(state, mesh):
    """A rank's local state from the full one: its rows of every
    row-sharded leaf. Every other leaf is the same tensor, not a copy.
    Works on a ``TrainState``, an LM's params tree or its ``OptState``."""
    return _map_rows(state, lambda x: shard_rows(x, mesh))


def gather_train_state(state, mesh):
    """The full state from the ranks' local states (a collective over
    ``model``, called on every rank): what a one-rank run holds, and what a
    checkpoint written under the mesh stores."""
    return _map_rows(state, lambda x: gather_rows(x, mesh))


def shard_head(tree, mesh):
    """:func:`shard_train_state` for a standalone head (``HeadParams`` and
    its ``OptState``): every array leaf is row-indexed but SM3's column
    cover."""
    return _map_rows(tree, lambda x: shard_rows(x, mesh), _head_row)


def gather_head(tree, mesh):
    """The inverse of :func:`shard_head` (a collective over ``model``)."""
    return _map_rows(tree, lambda x: gather_rows(x, mesh), _head_row)
