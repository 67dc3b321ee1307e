"""Placement on a ``("data", "model")`` mesh, the port of
``repro.parallel.sharding``.

The port runs one process per rank and holds plain local tensors (no
``DTensor``: every kernel would have to unwrap one).

The model is placed by :func:`param_spec`, the reference's rules over
``model``: attention heads (``wq``, ``wk``, ``wv`` column-parallel where
the head count divides, ``wo`` row-parallel), the MLP's ``d_ff``, the
MoE's experts (or each expert's ``d_ff`` where the expert count does not
divide) and its shared experts' ``d_ff``, the SSM's ``w_out`` rows, and the
embedding's and the head's rows (a ``model`` rank owns the contiguous rows
``[r·V/tp, (r+1)·V/tp)`` of each). Every other leaf is whole on every rank.
:func:`cache_spec` and :func:`paged_cache_spec` place the KV cache, the
paged arena and the SSM state. A block reads from its leaves' shapes which
of them a rank holds a part of (a local shape below the config's).

One set of functions places parameters (for serving and training alike)
and the training state: :func:`train_state_spec`, the counterpart of the
reference's ``train_state_shardings``, gives the parameters as above, the
optimizer state mirroring them (a row-indexed piece, such as a 1-D
accumulator, SM3's row cover, an int8 leaf's per-row scales or lazy
AdamW's ``last``, takes its parameter's dim-0 axis; SM3's column cover is
whole; a full-shape piece takes the parameter's spec), and the step
counters, the generator state and the SNR pair whole.
:func:`shard_train_state` and :func:`gather_train_state` convert between
a full tree (parameters, or a whole state: a one-rank run's, a
checkpoint's, or one carried across from the JAX package by
:mod:`repro_torch.convert`) and a rank's part of it;
:func:`iter_gathered_leaves` gathers one leaf at a time, so that a writer
never holds the whole trunk; :func:`split_bytes` counts what a rank
holds; :func:`split_axes` and :func:`split_dims` name the axes that cut a
leaf.

``param_spec``'s ``data`` entries are FSDP, as in the reference: each
``data`` rank holds its contiguous part, ``[r·n/dp, (r+1)·n/dp)``, of the
dim they name in every trunk matrix, cut again inside its ``model`` part,
and the optimizer state mirrors that. The forward gathers a layer's parts
over ``data`` just before the layer runs and the backward reduce-scatters
its gradients (``collectives.gather_over_data``); the batch is split over
``data`` too. Where ``data`` has one rank nothing is cut over it.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree_util

MESH_DIMS = ("data", "model")


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


def _map_rows(tree, fn, is_row):
    pairs, spec = tree_util.flatten_with_paths(tree)
    return tree_util.unflatten(spec, [
        fn(x) if isinstance(x, torch.Tensor) and x.dim() and is_row(p) else x
        for p, x in pairs])


def _head_row(path: Tuple[str, ...]) -> bool:
    return path[-1:] != ("col",)


def shard_head(tree, mesh):
    """A rank's rows of a standalone head (``HeadParams`` and its
    ``OptState``): every array leaf is row-indexed but SM3's column
    cover."""
    return _map_rows(tree, lambda x: shard_rows(x, mesh), _head_row)


def gather_head(tree, mesh):
    """The inverse of :func:`shard_head` (a collective over ``model``)."""
    return _map_rows(tree, lambda x: gather_rows(x, mesh), _head_row)


# ---------------------------------------------------------------------------
# The model's placement over ``model``
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
    dim divides is :func:`shard_train_state`'s check."""
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


def split_axes(spec: Spec, mesh) -> Dict[str, int]:
    """The axes that cut a leaf placed by ``spec`` on ``mesh``, each to the
    dim it cuts: ``model`` and ``data`` where they name a dim and have more
    than one rank (``mesh``: a ``DeviceMesh`` or a (data, model) shape)."""
    dp, tp = mesh_shape(mesh)
    return {ax: spec.index(ax) for ax, n in (("model", tp), ("data", dp))
            if n > 1 and ax in spec}


def _cut(x: torch.Tensor, spec: Spec, mesh, name: str) -> torch.Tensor:
    """This rank's part of a full leaf: its ``model`` dim and its ``data``
    dim each narrowed to the rank's contiguous range (a copy that owns its
    storage), the leaf itself where no dim is cut. A dim that does not
    divide raises."""
    axes = split_axes(spec, mesh)
    if not axes:
        return x
    for ax, dim in axes.items():
        k, n = size(mesh, ax), x.shape[dim]
        if n % k:
            raise ValueError(f"{name}: dimension {dim} of {n} does not divide over "
                             f"{k} {ax} ranks")
        x = x.narrow(dim, rank(mesh, ax) * (n // k), n // k)
    return x.clone()


# ---------------------------------------------------------------------------
# The training state's placement
# ---------------------------------------------------------------------------

_BOX_FIELDS = (("row", "col"), ("q", "scale"))       # Sm3Cover, QuantizedRows
_WHOLE_FIELDS = ("step", "head_state", "gen_fit_step", "snr_ewma", "snr_ref")
_MOMENTS = ("mu", "nu", "last")


def _is_box(x) -> bool:
    return isinstance(x, tuple) and tuple(getattr(x, "_fields", ())) in _BOX_FIELDS


def _role(path: Tuple[str, ...]):
    """("param" | "state" | "whole", the parameter's path) of a leaf of a
    ``TrainState``, a params tree or an ``OptState``."""
    if path[:1] == ("params",):
        return "param", path[1:]
    if path[:1] == ("opt_state",):
        path = path[1:]
        if path[:1] not in [(m,) for m in _MOMENTS]:
            return "whole", path
    if path[:1] in [(m,) for m in _MOMENTS]:
        return "state", path[1:]
    if path[:1] in [(f,) for f in _WHOLE_FIELDS]:
        return "whole", path
    return "param", path


def _state_leaf_spec(p_spec: Spec, ndim: int, field: Optional[str] = None) -> Spec:
    """The reference's ``_state_leaf_sharding``: a box field, or a state
    leaf of ``ndim`` dims, of a parameter placed by ``p_spec``."""
    row = (p_spec[0],) if p_spec else ()
    if field == "col":
        return (None,)
    if field in ("row", "scale"):
        return row
    if field == "q" or ndim > 1:
        return p_spec
    return () if ndim == 0 else row


def train_state_spec(cfg, mesh, state, prefix: Tuple[str, ...] = ()
                     ) -> List[Tuple[Tuple[str, ...], Spec]]:
    """(path, spec) of every leaf of ``state``, in :func:`tree_util.flatten`
    order, as the reference's ``train_state_shardings`` places them (module
    docstring): a tuple of axis names (``"data"``, ``"model"`` or None) a
    tensor dim, ``()`` for a Python number. ``state`` is a ``TrainState``,
    its ``as_pytree()`` dict, an LM's params tree or an ``OptState``, full
    or a rank's (only the number of dims is read). ``mesh`` is a
    ``DeviceMesh`` or a (data, model) shape. ``cfg`` is read only for the
    trunk's blocks; a tree of the embedding and the head alone needs none.
    ``prefix`` names the keys above ``state`` where it is a subtree, e.g.
    ``("layers", "3")`` for one layer's dict."""
    out: List[Tuple[Tuple[str, ...], Spec]] = []
    for path, x in tree_util.flatten_with_paths(state, is_leaf=_is_box)[0]:
        path = tuple(prefix) + path
        role, p_path = _role(path)
        if _is_box(x):
            p_spec = param_spec(cfg, mesh, p_path, x[0])
            out.extend((path + (f,), _state_leaf_spec(p_spec, leaf.dim(), f))
                       for f, leaf in zip(x._fields, x))
            continue
        nd = len(getattr(x, "shape", ()))
        if role == "whole" or not isinstance(x, torch.Tensor):
            out.append((path, (None,) * nd))
        elif role == "param":
            out.append((path, param_spec(cfg, mesh, p_path, x)))
        else:
            out.append((path, _state_leaf_spec(param_spec(cfg, mesh, p_path, x), nd)))
    return out


def split_dims(cfg, mesh, params) -> Dict[Tuple[str, ...], Spec]:
    """The path of every leaf of a params tree that the mesh cuts, to its
    axes a dim: ``"model"``, ``"data"`` or None, None also where the axis
    has one rank (the optimizer's ``split_dims``). Leaves the mesh keeps
    whole are left out."""
    out = {}
    for path, sp in train_state_spec(cfg, mesh, params):
        axes = split_axes(sp, mesh)
        if axes:
            out[path] = tuple(ax if ax in axes else None for ax in sp)
    return out


def _gather_leaf(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's part (a collective over each axis
    that cuts it: ``model``, then ``data``), or the leaf itself where it is
    whole."""
    for ax, dim in split_axes(spec, mesh).items():
        g = group(mesh, ax)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, x.contiguous(), group=g)
        x = torch.cat(parts, dim=dim)
    return x


def shard_train_state(state, mesh, cfg=None, prefix: Tuple[str, ...] = ()):
    """A rank's local state from the full one (:func:`train_state_spec`):
    each leaf split over ``model`` cut to the rank's part (a copy that
    owns its storage; a dim that does not divide raises a ``ValueError``
    naming the leaf); every other leaf is the same object, not a copy.
    Works on a ``TrainState``, an LM's params tree (or its subtree at
    ``prefix``, as ``transformer.init_params(mesh=)`` cuts each layer as
    it is drawn) or its ``OptState``; ``cfg`` (the model's config) is
    needed where the tree holds the trunk. A leaf is cut over ``data``
    too where its spec names ``data`` and the mesh has more than one data
    rank (FSDP)."""
    leaves, tdef = tree_util.flatten(state)
    specs = train_state_spec(cfg, mesh, state, prefix)
    return tree_util.unflatten(tdef, [
        _cut(x, sp, mesh, _path_name(p)) if isinstance(x, torch.Tensor) else x
        for x, (p, sp) in zip(leaves, specs)])


def iter_gathered_leaves(state, mesh, cfg=None) -> Iterator[Any]:
    """The full state's leaves, in :func:`tree_util.flatten` order, one at a
    time: each split leaf gathered from every rank that holds a part of it
    (over ``model``, then ``data``) when it is reached (a collective, so
    every rank must walk the whole iterator in step), the rest as they
    are. A writer holds one gathered leaf at a
    time, never the whole trunk."""
    leaves = tree_util.leaves(state)
    for x, (_, sp) in zip(leaves, train_state_spec(cfg, mesh, state)):
        yield _gather_leaf(x, sp, mesh) if isinstance(x, torch.Tensor) else x


def gather_train_state(state, mesh, cfg=None):
    """The full state from the ranks' local states (a collective over
    ``model`` and ``data``, called on every rank): what a one-rank run holds. It holds
    the whole trunk; writers go through :func:`iter_gathered_leaves`."""
    return tree_util.unflatten(tree_util.flatten(state)[1],
                               list(iter_gathered_leaves(state, mesh, cfg)))


def _ranks_on(ax, mesh) -> int:
    dp, tp = mesh_shape(mesh)
    return {"model": tp, "data": dp}.get(ax, 1)


def full_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The full shape of a rank's leaf of ``shape`` placed by ``spec``:
    its ``model`` dim times the model ranks, its ``data`` dim times the
    data ranks (the inverse of :func:`local_shape`)."""
    return tuple(n * _ranks_on(ax, mesh) for n, ax in zip(shape, spec))


class StateLayout:
    """The placement of a rank's state, leaf by leaf (:func:`train_state_spec`
    in flatten order), for a checkpoint's reader: each leaf's full shape,
    and a full leaf cut to the rank's part."""

    def __init__(self, state, mesh, cfg=None):
        self.mesh = mesh
        self.specs = train_state_spec(cfg, mesh, state)

    def full_shape(self, i: int, like) -> Tuple[int, ...]:
        return full_shape(tuple(np.shape(like)), self.specs[i][1], self.mesh)

    def cut(self, i: int, x: torch.Tensor) -> torch.Tensor:
        path, spec = self.specs[i]
        return _cut(x, spec, self.mesh, _path_name(path))


class SplitBytes(NamedTuple):
    """The bytes of a full tree by the axes that cut each leaf: over
    ``model`` only, over ``data`` only, over both, and whole."""
    model: int
    data: int
    both: int
    whole: int

    @property
    def total(self) -> int:
        return self.model + self.data + self.both + self.whole

    def a_rank(self, mesh) -> int:
        """What a rank of ``mesh`` holds: model / tp + data / dp + both /
        (dp·tp) + whole, exactly (each leaf's cut divides)."""
        dp, tp = mesh_shape(mesh)
        return self.model // tp + self.data // dp + self.both // (dp * tp) + self.whole


def split_bytes(tree, cfg, mesh) -> SplitBytes:
    """The bytes of the leaves of a full ``tree`` (a params tree, an
    ``OptState`` or a ``TrainState``; meta tensors will do) by the axes of
    ``mesh`` that :func:`train_state_spec` cuts them over
    (:func:`split_axes`: an axis of one rank cuts nothing)."""
    out = dict(model=0, data=0, both=0, whole=0)
    for x, (_, sp) in zip(tree_util.leaves(tree), train_state_spec(cfg, mesh, tree)):
        if not isinstance(x, torch.Tensor):
            continue
        axes = split_axes(sp, mesh)
        key = "both" if len(axes) == 2 else next(iter(axes), "whole")
        out[key] += x.numel() * x.element_size()
    return SplitBytes(**out)


def tree_bytes(tree) -> int:
    """Bytes of the tensor leaves of ``tree``."""
    return sum(x.numel() * x.element_size() for x in tree_util.leaves(tree)
               if isinstance(x, torch.Tensor))


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
    ``model`` dim divided by the model ranks, each ``data`` dim by the data
    ranks."""
    return tuple(n // _ranks_on(ax, mesh) for n, ax in zip(shape, spec))
