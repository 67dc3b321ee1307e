"""Decoder-only LM assembly: a loop over layers, embeddings, caches.

The port of ``repro.models.transformer``, for all four block families:
attention (with an MLP or a mixture of experts), Mamba-2 SSM (mamba2),
and hymba's parallel attention and SSM branches, mean-fused. Parameters
are plain dicts of tensors under the reference's key names; the layer stack
is a Python list of per-layer dicts (the reference stacks them for
``lax.scan``; ``convert.lm_params_from_numpy`` unstacks), and each layer
reads its own window (``cfg.window_for_layer(i)``, a Python int).

Modes:
  forward(..., cache=None)        — training / teacher forcing
  forward(..., cache, cache_pos)  — serving prefill (writes the cache) and
                                    single-token decode (S == 1), with a
                                    scalar ``cache_pos``; the cache is
                                    updated in place
  forward(..., cache, cache_pos=(B,))
                                  — the serving engine's slotted decode
  forward(..., arena, cache_pos=(B,), page_table=, write_mask=)
                                  — its paged steps over
                                    ``init_paged_cache``'s arena

Training passes ``attn_impl="plain"`` (the reference's attention under
autograd; the CUDA kernel is forward-only) and, for the sparse embedding
update, ``inputs_embeds`` (the token gather done outside the graph). With
``cfg.remat`` and grad mode on, each layer runs under
``torch.utils.checkpoint`` (non-reentrant): its input is saved, its inside
recomputed in the backward pass. The forward draws no random numbers, so
the recompute gives the same bits.

On a ("data", "model") mesh, serving holds a rank's part of the model
(``init_params(mesh=)`` or ``parallel.sharding.shard_train_state``) and of the
caches (``init_cache(mesh=)``, ``init_paged_cache(mesh=)``), and
``forward(mesh=)`` runs each block on it: the attention heads, the MLP's
and the experts' ``d_ff``, the experts themselves and the SSM heads are
split over ``model`` as ``param_spec`` places them, and each row-parallel
projection's partial sums are reduced over ``model``. Training runs the
same blocks on the same parts under autograd: the collectives are
differentiable (:mod:`repro_torch.parallel.collectives`), and where a rank
does only part of a block's work the partial gradients of its input and of
the whole leaves it reads in part are summed over ``model``. Every block
reads from its weights' shapes whether it holds a part.

With more than one ``data`` rank the trunk is FSDP as well
(``param_spec``'s ``data`` entries): each layer's leaves cut over ``data``
are gathered just before the layer runs (:func:`_gathered_layer`, one
``collectives.gather_over_data`` a layer, the MoE's expert weights in
``cfg.dtype`` under the hint ``fsdp_gather_weights``), so the block sees
the ``model`` parts it sees without FSDP; serving gathers every layer at
every step. Training then runs each layer under a non-reentrant
checkpoint whatever ``cfg.remat`` says, the gather inside it: autograd
would otherwise save each gathered weight for its matmul's backward,
keeping the whole trunk gathered until the backward. With the checkpoint
a layer's gathered weights die with its forward, the backward gathers
them again in the recompute, and their gradients leave the layer
reduce-scattered to the rank's parts.

Under the hint ``seq_parallel_residual`` (sequence parallelism,
:mod:`repro_torch.parallel.hints`) with tp > 1 and S dividing over
``model``, the stream between the blocks is the rank's S/tp rows: the
embedding's output is cut to them at the first block's entry (outside its
checkpoint, which then saves 1/tp of the unhinted input), each block gets
``seq=True`` (its norms and residual adds on the rank's rows, its entries
into split weights gathered along S, its row-parallel sums
reduce-scattered), and after the last block the stream is gathered back
along S for the final norm and the head. Decode and an S that tp does not
divide run as without the hint.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as checkpoint_lib

from repro_torch import device as device_lib
from repro_torch import tree_util
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives, hints, sharding


def _has_attn(cfg: ModelConfig) -> bool:
    return cfg.block in ("attn", "hybrid")


def _has_ssm(cfg: ModelConfig) -> bool:
    return cfg.block in ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_layer(generator: torch.Generator, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    p: Dict[str, Any] = {"norm_mix": L.init_rmsnorm(cfg.d_model, device)}
    if _has_attn(cfg):
        p["attn"] = L.init_attention(generator, cfg, device)
    if _has_ssm(cfg):
        p["ssm"] = ssm_lib.init_ssm_block(generator, cfg, device)
    if cfg.is_moe:
        p["moe"] = moe_lib.init_moe(generator, cfg, device)
    elif cfg.d_ff > 0:
        p["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff, device)
    if cfg.is_moe or cfg.d_ff > 0:      # mamba2: the SSM block is the whole layer
        p["norm_ffn"] = L.init_rmsnorm(cfg.d_model, device)
    return p


def _cast_layer(lp: Dict[str, Any], cdt: torch.dtype) -> Dict[str, Any]:
    """A layer with the matrices its forward casts to ``cfg.dtype`` cast
    once: attention and MLP weights, the SSM's in and out projections, the
    experts (routed and shared). Norms, the router and the SSM's conv, decay
    and skip parameters stay float32, as the forward reads them."""
    out = dict(lp)
    for key in ("attn", "mlp"):
        if key in lp:
            out[key] = {k: v.to(cdt) for k, v in lp[key].items()}
    if "ssm" in lp:
        out["ssm"] = {**lp["ssm"], "w_in": lp["ssm"]["w_in"].to(cdt),
                      "w_out": lp["ssm"]["w_out"].to(cdt)}
    if "moe" in lp:
        m = {**lp["moe"], **{k: lp["moe"][k].to(cdt) for k in ("w_gate", "w_up", "w_down")}}
        if "shared" in m:
            m["shared"] = {k: v.to(cdt) for k, v in m["shared"].items()}
        out["moe"] = m
    return out


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda", cast: bool = False, mesh=None) -> Dict[str, Any]:
    """Parameters drawn on ``generator``'s device, put on ``device``:
    ``embed`` (V_pad, d), ``layers`` (a list of per-layer dicts),
    ``final_norm``, ``head`` {w (V_pad, d), b (V_pad,)}, all float32.

    With ``cast`` the embedding and each layer's matrices come cast to
    ``cfg.dtype`` (:func:`cast_params`'s result, bit for bit), each layer as
    soon as it is drawn: the model never exists whole in float32
    (deepseek-moe-16b is 67.5 GB in float32, 33.8 GB in bf16). Serving
    builds this way; :func:`cast_params` is for converted parameters.

    With ``mesh`` each rank draws every tensor from the same ``generator``
    state, so the draws are one model's on every rank, and keeps its part
    (:func:`repro_torch.parallel.sharding.shard_train_state`) before it draws the
    next layer: no rank holds more than one whole layer at a time.
    """
    dev = device_lib.resolve(device)
    cdt = L._dtype(cfg)
    vp, d = cfg.padded_vocab, cfg.d_model

    def own(tree, *prefix):
        return tree if mesh is None else sharding.shard_train_state(tree, mesh, cfg, prefix)

    embed = L.normal_init(generator, (vp, d), d, device=dev)
    if cast:
        embed = embed.to(cdt)
    embed = own({"embed": embed})["embed"]
    layers = []
    for i in range(cfg.num_layers):       # no reference to a whole layer outlives its turn
        lp = init_layer(generator, cfg, dev)
        layers.append(own(_cast_layer(lp, cdt) if cast else lp, "layers", str(i)))
        del lp
    head = {"w": L.normal_init(generator, (vp, d), d, device=dev),
            "b": torch.zeros((vp,), dtype=torch.float32, device=dev)}
    return {"embed": embed, "layers": layers, "final_norm": L.init_rmsnorm(d, dev),
            "head": own(head, "head")}


def cast_params(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The parameters with the embedding and every layer's matrices cast once
    to ``cfg.dtype``, for serving converted parameters (:func:`_cast_layer`;
    ``init_params(cast=True)`` builds so directly); norms, the router, the
    SSM's small parameters and the head stay float32.

    The reference keeps float32 weights and casts each to ``cfg.dtype`` at
    every use; both frameworks round float32 to bfloat16 to nearest even, so
    casting once computes the same function, and the forward's casts become
    no-ops. At h2o-danube-3-4b width, recasting at every decode step would
    move about 24 GB a step.
    """
    cdt = L._dtype(cfg)
    return {**params, "embed": params["embed"].to(cdt),
            "layers": [_cast_layer(lp, cdt) for lp in params["layers"]]}


# ---------------------------------------------------------------------------
# Caches (stacked over layers)
# ---------------------------------------------------------------------------

def _cache_leaves(shapes: Dict[str, Tuple[int, ...]], dtype, dev, spec,
                  mesh) -> Dict[str, torch.Tensor]:
    """Zeros of each leaf's shape, or under ``mesh`` of a rank's part of it
    as ``spec`` places it over ``model``; k and v in ``dtype``, the SSM's
    float32. The batch dim stays whole: every ``data`` rank of a serving
    launcher serves the same requests, so a rank's batch is the whole one."""
    return {key: torch.zeros(shape if mesh is None else sharding.local_shape(
                shape, tuple(None if ax == "data" else ax for ax in spec[key]), mesh),
                dtype=dtype if key in ("k", "v") else torch.float32, device=dev)
            for key, shape in shapes.items()}


def _leaf_shapes(cfg: ModelConfig, rows: int, seq: Tuple[int, int]) -> Dict[str, tuple]:
    shapes: Dict[str, tuple] = {}
    ell = cfg.num_layers
    if _has_attn(cfg):
        shapes["k"] = shapes["v"] = (ell,) + seq + (cfg.num_kv_heads, cfg.resolved_head_dim)
    if _has_ssm(cfg):
        shapes["conv"] = (ell, rows, cfg.ssm_conv_width - 1, cfg.ssm_inner + 2 * cfg.ssm_state)
        shapes["state"] = (ell, rows, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    return shapes


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", mesh=None) -> Dict[str, torch.Tensor]:
    """Decode cache, zeros: k and v of shape (L, B, max_len, KV, hd) in
    ``dtype`` for attention; conv (L, B, W-1, di + 2N) and state
    (L, B, H, N, P) for an SSM branch, float32 whatever ``dtype`` is, as
    the reference's. With ``mesh``, a rank's part of a cache of ``batch``
    rows (the batch the rank serves): KV heads and SSM heads split over
    ``model`` where ``parallel.sharding.cache_spec`` splits them."""
    spec = None if mesh is None else sharding.cache_spec(cfg, mesh, batch)
    return _cache_leaves(_leaf_shapes(cfg, batch, (batch, max_len)), dtype,
                         device_lib.resolve(device), spec, mesh)


def init_paged_cache(cfg: ModelConfig, n_lanes: int, n_pages: int, page_len: int,
                     dtype=torch.bfloat16, device="cuda", mesh=None) -> Dict[str, torch.Tensor]:
    """Paged decode cache: the attention K/V live in a shared arena of
    ``n_pages`` physical pages of ``page_len`` positions (the allocator's
    sink page included), k and v of shape (L, n_pages, page_len, KV, hd),
    zeros, addressed through per-lane page tables. An SSM branch's conv and
    state have no sequence dimension to page: they stay lane-indexed,
    (L, n_lanes, ...), float32. With ``mesh``, a rank's part as
    ``parallel.sharding.paged_cache_spec`` places it."""
    spec = None if mesh is None else sharding.paged_cache_spec(cfg, mesh, n_lanes)
    return _cache_leaves(_leaf_shapes(cfg, n_lanes, (n_pages, page_len)), dtype,
                         device_lib.resolve(device), spec, mesh)


# ---------------------------------------------------------------------------
# Block body
# ---------------------------------------------------------------------------

def _block(layer_params, cfg: ModelConfig, h, positions, window: int,
           cache_l, cache_pos, attn_impl: str = "kernel", decode: bool = False,
           mask_pos=None, mesh=None, seq: bool = False):
    """One decoder block. Returns (h, metrics); a cache's leaves are
    written in place. On a rank's part of the layer every branch returns
    the sum over ``model`` (module docstring). ``seq``: h is the rank's
    rows of the sequence (sequence parallelism, :mod:`repro_torch.parallel.hints`);
    the norms then run on those rows alone, so their scales' gradients are
    partial and summed over ``model``, as are a whole MLP's."""
    metrics: Dict[str, torch.Tensor] = {}

    def whole(p):          # a whole leaf used on the rank's rows alone
        return tree_util.tree_map(lambda t: collectives.copy_to_model(mesh, t), p) if seq else p

    mix_in = L.rmsnorm(whole(layer_params["norm_mix"]), h)
    mix_out = None
    if _has_attn(cfg):
        kvc = (cache_l["k"], cache_l["v"]) if cache_l is not None else None
        mix_out, _ = L.attention(layer_params["attn"], cfg, mix_in, positions, window,
                                 kv_cache=kvc, cache_pos=cache_pos, impl=attn_impl,
                                 mask_pos=mask_pos, mesh=mesh, seq=seq)
    if _has_ssm(cfg):
        sc = (cache_l["conv"], cache_l["state"]) if cache_l is not None else None
        s_out, (conv, state) = ssm_lib.ssm_block(layer_params["ssm"], cfg, mix_in,
                                                 cache=sc, decode=decode, mesh=mesh, seq=seq)
        if cache_l is not None:
            cache_l["conv"].copy_(conv)
            cache_l["state"].copy_(state)
        # hymba: the mean of the parallel branches, in the branches' dtype.
        mix_out = s_out if mix_out is None else (mix_out + s_out) / 2.0
    h = h + mix_out.to(h.dtype)

    if cfg.is_moe or cfg.d_ff > 0:
        ffn_in = L.rmsnorm(whole(layer_params["norm_ffn"]), h)
        if cfg.is_moe:
            f_out, moe_metrics = moe_lib.moe_ffn(layer_params["moe"], cfg, ffn_in, mesh=mesh,
                                                 seq=seq)
            metrics.update(moe_metrics)
        else:
            split = layer_params["mlp"]["w_down"].shape[0] < cfg.d_ff
            # A whole MLP is token-wise: it runs on the rank's rows.
            f_out = L.mlp(layer_params["mlp"] if split else whole(layer_params["mlp"]),
                          ffn_in, L._dtype(cfg), mesh=mesh if split else None,
                          seq=seq and split)
        h = h + f_out.to(h.dtype)
    return h, metrics


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Token embedding in ``cfg.dtype``; a vision frontend's precomputed
    (B, n_vis, d) embeddings are prepended (the modality stub). Under a
    ``mesh`` the table holds this rank's rows and the gather is
    ``collectives.sharded_gather_rows`` (a collective over ``model``)."""
    cdt = L._dtype(cfg)
    if mesh is not None:
        from repro_torch.parallel.collectives import sharded_gather_rows
        h = sharded_gather_rows(mesh, params["embed"], tokens).to(cdt)
    else:
        h = params["embed"][tokens].to(cdt)
    if vision_embeds is not None:
        h = torch.cat([vision_embeds.to(device=h.device, dtype=cdt), h], dim=1)
    return h


def _check_positions(positions: torch.Tensor, cache_pos, bsz: int, s: int) -> None:
    """The kernel masks by index: explicit positions may reach it only where
    their first stream is ``cache_pos + arange(S)`` row by row. Read on the
    host; anything else raises. Fake tensors (the dry run) hold no values:
    their positions are taken as that default."""
    if device_lib.is_fake(positions):
        return
    p0 = L.to_host(positions if positions.ndim == 2 else positions[0])
    cp = np.broadcast_to(L.to_host(0 if cache_pos is None else cache_pos)
                         .astype(np.int64).reshape(-1), (bsz,))
    if p0.shape != (bsz, s) or not (p0 == cp[:, None] + np.arange(s)).all():
        raise ValueError(
            "flash_attention masks by index: explicit positions must have "
            "positions[0] == cache_pos + arange(S) in every row; pass "
            "attn_impl='plain' (no cache) for other positions")


@contextlib.contextmanager
def _recomputing(hint_ctx):
    with collectives.recomputing(), hints.installed(hint_ctx):
        yield


def _recompute_contexts(hint_ctx):
    """The checkpoint's ``context_fn``: its (forward, recompute) contexts.
    The recomputed layer's collectives count as the recompute's
    (``collectives.TRUNK``), and it runs under the hints the forward ran
    under (``hint_ctx``): the recompute may run on another thread."""
    return lambda: (contextlib.nullcontext(), _recomputing(hint_ctx))


_EXPERTS = (("moe", "w_gate"), ("moe", "w_up"), ("moe", "w_down"))


def _fsdp_plan(cfg: ModelConfig, mesh, layer) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                                                       Tuple[str, ...]]:
    """(flatten indices, data dims, names) of a layer's leaves cut over
    ``data``: the same for every layer, read from ``layer``."""
    idx, dims, names = [], [], []
    for i, (path, sp) in enumerate(sharding.train_state_spec(cfg, mesh, layer,
                                                             ("layers", "0"))):
        axes = sharding.split_axes(sp, mesh)
        if "data" in axes:
            idx.append(i)
            dims.append(axes["data"])
            names.append("/".join(path[2:]))
    return tuple(idx), tuple(dims), tuple(names)


def _gathered_layer(layer, cfg: ModelConfig, mesh, plan):
    """A layer with its ``data`` parts gathered over ``data`` (FSDP): one
    collective, differentiable (module docstring)."""
    idx, dims, names = plan
    pairs, spec = tree_util.flatten_with_paths(layer)
    leaves = [x for _, x in pairs]
    cdt = L._dtype(cfg)
    dtypes = [hints.hint_gathered_weight(leaves[i], cdt) if pairs[i][0] in _EXPERTS
              else leaves[i].dtype for i in idx]
    full = collectives.gather_over_data(mesh, [leaves[i] for i in idx], dims, dtypes, names)
    for i, x in zip(idx, full):
        leaves[i] = x
    return tree_util.unflatten(spec, leaves)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_pos=None, inputs_embeds: Optional[torch.Tensor] = None,
            attn_impl: str = "kernel", page_table=None,
            write_mask=None, mesh=None) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
    """Run the stack. Returns (hidden (B,S,d), cache, metrics).

    - training:        cache=None
    - serving prefill: cache=init_cache(...), cache_pos=0, S=prompt len
    - serving decode:  cache from prefill, cache_pos=current, S=1;
      cache_pos may be a (B,) vector (slotted decode, the serving engine):
      each row writes its K/V at its own depth
    - paged:           cache=init_paged_cache(...), cache_pos (B,),
      page_table (B, max_pages) mapping each lane's logical pages onto the
      shared arena, shared by every layer. S may exceed 1 (shared-prefix
      suffix prefill and the speculative verify step, attention models
      only): row r's tokens take logical positions cache_pos[r] ..
      cache_pos[r]+S-1, and ``write_mask`` (B, S) sends padding positions'
      K/V to the sink page

    With a cache, S == 1 is a decode step: an SSM branch advances its state
    one token from the cache's (a lane's row of the paged cache's
    lane-indexed leaves); S > 1 is a prefill, which starts the SSM from the
    cache's state and overwrites its conv state. ``cache_pos`` is a scalar
    (a Python int or a 0-dim tensor) or (B,); the cache is written in place
    and returned. For a per-row ``cache_pos`` the step's indices (positions,
    write rows, key counts, the page table) are built on the host and
    copied to the device once (:func:`layers.cache_index`); pass
    ``cache_pos`` and ``page_table`` as host arrays to keep the step free of
    device reads.

    ``positions`` default to ``cache_pos + arange(S)`` per row. Explicit
    positions are (B, S), or (3, B, S) for M-RoPE (qwen2-vl); the kernel
    path (``attn_impl="kernel"``) takes them only where ``positions[0]`` is
    that default (checked on the host, else ValueError); the plain path
    masks by ``positions[0]``, as the reference does without a cache.
    ``vision_embeds`` (B, n_vis, d) are prepended to the token embeddings.

    ``inputs_embeds`` (B, S, d), already in ``cfg.dtype`` (vision embeds
    already prepended), replaces the embedding gather: the sparse-embedding
    training path gathers outside the autograd graph and collects the rows'
    gradients itself. ``attn_impl`` is ``"kernel"`` (serving) or
    ``"plain"`` (training, see :func:`repro_torch.models.layers.attention`).

    ``mesh``: the embedding is row-sharded over its ``model`` dim
    (:func:`embed_inputs`), and each block runs on the rank's part of its
    weights and cache, whole where they are whole (module docstring).

    ``metrics``: a mixture-of-experts model's ``moe_dropped_frac`` and
    ``moe_router_entropy``, each the mean over layers; otherwise empty.
    """
    h = (inputs_embeds if inputs_embeds is not None
         else embed_inputs(params, cfg, tokens, vision_embeds, mesh=mesh))
    bsz, s, _ = h.shape
    base = 0 if cache_pos is None else cache_pos
    mask_pos = None
    if positions is not None:
        positions = torch.as_tensor(positions).to(device=h.device, dtype=torch.int64)
        if attn_impl == "plain":
            mask_pos = positions if positions.ndim == 2 else positions[0]
        elif _has_attn(cfg):
            _check_positions(positions, cache_pos, bsz, s)
    if _has_attn(cfg):                       # an SSM reads no positions
        if cache is not None and (L.is_per_row(base) or page_table is not None):
            ck = cache["k"]
            if page_table is not None:
                base = L.cache_index(base, bsz, s, h.device, page_table=page_table,
                                     write_mask=write_mask, page_len=ck.shape[2],
                                     sink=ck.shape[1] - 1)
            else:
                base = L.cache_index(base, bsz, s, h.device, s_max=ck.shape[2])
            auto = base.positions
        else:
            if isinstance(base, torch.Tensor) or isinstance(base, np.ndarray):
                if base.ndim > 0:
                    raise ValueError("a per-row cache_pos needs a cache")
                base = int(base)
            auto = (base + torch.arange(s, device=h.device)).expand(bsz, s)
        positions = auto if positions is None else positions
    decode = cache is not None and s == 1
    fsdp = (mesh is not None and sharding.size(mesh, "data") > 1
            and len(params["layers"]) > 0)
    plan = _fsdp_plan(cfg, mesh, params["layers"][0]) if fsdp else None

    def layer_of(lp):
        return _gathered_layer(lp, cfg, mesh, plan) if fsdp else lp

    remat = (cfg.remat or fsdp) and cache is None and torch.is_grad_enabled()
    # Sequence parallelism: the rank's rows of the stream between blocks.
    rows = hints.residual_rows(s) if mesh is not None else None
    seq = rows is not None
    layer_metrics = []
    for i, layer_params in enumerate(params["layers"]):
        cache_l = None if cache is None else {k: leaf[i] for k, leaf in cache.items()}
        window = cfg.window_for_layer(i)
        # At each block's entry, outside its checkpoint: the checkpoint then
        # keeps the rank's rows of its input alone.
        h = hints.hint_residual(h, rows)
        if remat:
            h, metrics = checkpoint_lib.checkpoint(
                lambda lp, x, w=window: _block(layer_of(lp), cfg, x, positions, w, None,
                                               base, attn_impl, mask_pos=mask_pos, mesh=mesh,
                                               seq=seq),
                layer_params, h, use_reentrant=False,
                context_fn=_recompute_contexts(hints.current()))
        else:
            h, metrics = _block(layer_of(layer_params), cfg, h, positions, window, cache_l,
                                base, attn_impl, decode=decode, mask_pos=mask_pos, mesh=mesh,
                                seq=seq)
        layer_metrics.append(metrics)
    if seq:
        # Every rank computes the head's whole loss from the gathered stream.
        h = collectives.gather_seq_over_model(mesh, hints.hint_residual(h, rows))
    h = L.rmsnorm(params["final_norm"], h)
    metrics = {k: torch.stack([m[k] for m in layer_metrics]).mean()
               for k in layer_metrics[0]} if layer_metrics else {}
    return h, cache, metrics
