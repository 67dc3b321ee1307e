"""Placement on a ``("data", "model")`` mesh, the port of
``repro.parallel.sharding``.

The port runs one process per rank and holds plain local tensors (no
``DTensor``: every kernel would have to unwrap one).

Serving places the whole model by :func:`param_spec`, the reference's
rules over ``model``: attention heads (``wq``, ``wk``, ``wv`` column-parallel
where the head count divides, ``wo`` row-parallel), the MLP's ``d_ff``, the
MoE's experts (or each expert's ``d_ff`` where the expert count does not
divide) and its shared experts' ``d_ff``, the SSM's ``w_out`` rows, and the
embedding's and the head's rows. :func:`shard_params` cuts a rank's part
from the full parameters and :func:`gather_params` puts them back together
(a collective over ``model``). ``param_spec``'s ``data`` entries are FSDP,
a training concern: the port keeps every tensor whole over ``data``.
:func:`cache_spec` and :func:`paged_cache_spec` place the KV cache, the
paged arena and the SSM state. A block reads from its leaves' shapes which
of them a rank holds a part of (a local shape below the config's).

Training shards only the embedding and the head: ``P("model", None)`` in
the reference, a ``model`` rank owns the contiguous rows
``[r·V/tp, (r+1)·V/tp)`` of each, and so of every row-indexed piece of
their optimizer state (the accumulators, an int8 payload and its per-row
scales, SM3's row cover, lazy AdamW's ``last``). SM3's column cover, the
step counters, the generator state and the trunk stay whole on every rank
there. The batch is split over ``data``. :func:`shard_train_state` and
:func:`gather_train_state` convert between the full state (a one-rank
run's, a checkpoint's, or one carried across from the JAX package by
:mod:`repro_torch.convert`) and a rank's local state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


# ---------------------------------------------------------------------------
# The model's placement over ``model`` (serving)
# ---------------------------------------------------------------------------

Spec = Tuple[Optional[str], ...]


def mesh_shape(mesh) -> Tuple[int, int]:
    """(data, model) sizes of a ``DeviceMesh``, or of a (data, model) tuple
    (the rules alone need no process group)."""
    if isinstance(mesh, (tuple, list)):
        return int(mesh[0]), int(mesh[1])
    return size(mesh, "data"), size(mesh, "model")


def param_spec(cfg, mesh, path, leaf) -> Spec:
    """The reference's ``param_spec`` for one parameter leaf, as a tuple of
    axis names (``"data"``, ``"model"`` or None) over the leaf's dims. The
    port keeps a list of per-layer dicts where the reference stacks layers
    on a leading dim, so a layer leaf's spec drops that leading None.
    ``path`` names the keys down to the leaf (a layer's list index is
    skipped); ``leaf`` gives the number of dims. Only the spec: whether a
    dim divides is :func:`shard_params`'s check."""
    names = tuple(str(p) for p in path if not str(p).isdigit())
    _, tp = mesh_shape(mesh)
    nd = len(leaf.shape)
    last = names[-1] if names else ""

    def spec(*entries) -> Spec:
        return tuple(entries) + (None,) * (nd - len(entries))

    def over(n: int) -> Optional[str]:
        return "model" if n % tp == 0 else None

    if "embed" in names:
        return spec("model")
    if "head" in names:
        return spec("model")
    if "attn" in names:
        if last == "wq":
            return ("data", over(cfg.num_heads), None)
        if last in ("wk", "wv"):
            return ("data", over(cfg.num_kv_heads), None)
        if last == "wo":
            return (over(cfg.num_heads), None, "data")
    if "moe" in names:
        e_div = cfg.n_experts % tp == 0
        if last == "router":
            return ("data", None)
        if "shared" in names:
            return ("model", "data") if last == "w_down" else ("data", "model")
        if last in ("w_gate", "w_up"):
            return ("model", "data", None) if e_div else (None, "data", "model")
        if last == "w_down":
            return ("model", None, "data") if e_div else (None, "model", "data")
    if "mlp" in names:
        return ("model", "data") if last == "w_down" else ("data", "model")
    if "ssm" in names:
        if last == "w_in":
            return ("data", None)
        if last == "w_out":
            return (over(cfg.ssm_inner), "data")
    return spec()          # norms, biases, the SSM's conv and scalars: whole


def _path_name(path) -> str:
    return "/".join(str(p) for p in path)


def _cut(x: torch.Tensor, spec: Spec, mesh, name: str) -> torch.Tensor:
    """This rank's part of a full leaf: each ``model`` dim narrowed to the
    rank's contiguous range (a copy that owns its storage), the leaf itself
    where no dim is over ``model``. A dim that does not divide raises."""
    tp, r = size(mesh, "model"), rank(mesh, "model")
    cut = False
    for dim, ax in enumerate(spec):
        if ax != "model" or tp == 1:
            continue
        n = x.shape[dim]
        if n % tp:
            raise ValueError(f"{name}: dimension {dim} of {n} does not divide over "
                             f"{tp} model ranks")
        x, cut = x.narrow(dim, r * (n // tp), n // tp), True
    return x.clone() if cut else x


def _map_params(tree, cfg, mesh, fn, prefix=()):
    pairs, spec = tree_util.flatten_with_paths(tree)
    return tree_util.unflatten(spec, [
        fn(x, param_spec(cfg, mesh, prefix + p, x), _path_name(prefix + p))
        if isinstance(x, torch.Tensor) else x for p, x in pairs])


def shard_params(params, cfg, mesh, prefix: Tuple[str, ...] = ()):
    """A rank's part of the full parameters (an LM's tree, or the subtree
    at ``prefix``, e.g. ``("layers", "3")``), as :func:`param_spec`'s
    ``model`` entries place them; ``data`` entries are ignored. Leaves
    that stay whole are the same tensors, not copies."""
    return _map_params(params, cfg, mesh, lambda x, sp, name: _cut(x, sp, mesh, name), prefix)


def gather_params(params, cfg, mesh):
    """The full parameters from every ``model`` rank's part: the inverse of
    :func:`shard_params`, a collective over ``model`` called on every rank."""
    g = group(mesh, "model")

    def put_back(x, sp, name):
        for dim, ax in enumerate(sp):
            if ax == "model" and size(mesh, "model") > 1:
                parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
                dist.all_gather(parts, x.contiguous(), group=g)
                x = torch.cat(parts, dim=dim)
        return x

    return _map_params(params, cfg, mesh, put_back)


def trunk_bytes(params) -> int:
    """Bytes of the layers' leaves (the trunk: no embedding, head or final
    norm)."""
    return sum(x.numel() * x.element_size() for x in tree_util.leaves(params["layers"])
               if isinstance(x, torch.Tensor))


def split_trunk_bytes(params, cfg, mesh) -> Tuple[int, int]:
    """(bytes of the full trunk's leaves that :func:`param_spec` splits over
    ``model``, bytes of those that stay whole), from the full parameters
    (meta tensors will do). A rank of ``tp`` holds split / tp + whole."""
    split = whole = 0
    for p, x in tree_util.flatten_with_paths(params["layers"])[0]:
        n = x.numel() * x.element_size()
        if "model" in param_spec(cfg, mesh, ("layers",) + p, x) and mesh_shape(mesh)[1] > 1:
            split += n
        else:
            whole += n
    return split, whole


def cache_spec(cfg, mesh, batch: int) -> Dict[str, Spec]:
    """Placement of the decode cache's leaves, the counterpart of the
    reference's ``cache_shardings``: k and v (L, B, S, KV, hd), conv
    (L, B, W-1, conv_dim), state (L, B, H, N, P).

    The batch dim is over ``data`` where ``batch`` divides (the serving
    launchers give every ``data`` rank the same requests, so there a rank's
    batch is the whole one), and the SSM state's heads over ``model`` where
    ``ssm_heads`` divides; conv stays whole over ``model``: all as the
    reference places them.

    k and v differ, on purpose: the reference shards their sequence dim over
    ``model`` (GSPMD rewrites the decode softmax into sums across ranks);
    the port shards their KV heads over ``model`` where ``num_kv_heads``
    divides and keeps them whole otherwise. On explicit ranks attention then
    needs no collective inside it and ``flash_attention`` runs unchanged on
    a rank's heads; a rank holds 1/tp of the cache either way.
    """
    dp, tp = mesh_shape(mesh)
    b_ax = "data" if batch % dp == 0 else None
    out: Dict[str, Spec] = {}
    if cfg.block in ("attn", "hybrid"):
        kv_ax = "model" if cfg.num_kv_heads % tp == 0 else None
        out["k"] = out["v"] = (None, b_ax, None, kv_ax, None)
    if cfg.block in ("ssm", "hybrid"):
        out["state"] = (None, b_ax, "model" if cfg.ssm_heads % tp == 0 else None, None, None)
        out["conv"] = (None, b_ax, None, None)
    return out


def paged_cache_spec(cfg, mesh, n_lanes: int) -> Dict[str, Spec]:
    """Placement of the paged arena, the counterpart of the reference's
    ``paged_cache_shardings``: k and v (L, P, page_len, KV, hd) by KV heads
    over ``model`` where ``num_kv_heads`` divides, whole otherwise (the
    reference shards the within-page sequence dim instead; see
    :func:`cache_spec`); the lane-indexed SSM leaves as :func:`cache_spec`
    places a batch of ``n_lanes``."""
    out = cache_spec(cfg, mesh, n_lanes)
    for key in ("k", "v"):
        if key in out:
            out[key] = (None, None) + out[key][2:]
    return out


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """A rank's shape of a leaf of full ``shape`` placed by ``spec``: each
    ``model`` dim divided by the model ranks (``data`` dims untouched: the
    caller gives the rank's batch)."""
    _, tp = mesh_shape(mesh)
    return tuple(n // tp if ax == "model" else n for n, ax in zip(shape, spec))
