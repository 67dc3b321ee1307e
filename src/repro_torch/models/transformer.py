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
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import checkpoint as checkpoint_lib

from repro_torch import device as device_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig


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
                device="cuda", cast: bool = False) -> Dict[str, Any]:
    """Parameters drawn on ``generator``'s device, put on ``device``:
    ``embed`` (V_pad, d), ``layers`` (a list of per-layer dicts),
    ``final_norm``, ``head`` {w (V_pad, d), b (V_pad,)}, all float32.

    With ``cast`` the embedding and each layer's matrices come cast to
    ``cfg.dtype`` (:func:`cast_params`'s result, bit for bit), each layer as
    soon as it is drawn: the model never exists whole in float32
    (deepseek-moe-16b is 67.5 GB in float32, 33.8 GB in bf16). Serving
    builds this way; :func:`cast_params` is for converted parameters.
    """
    dev = device_lib.resolve(device)
    cdt = L._dtype(cfg)
    vp, d = cfg.padded_vocab, cfg.d_model
    embed = L.normal_init(generator, (vp, d), d, device=dev)
    if cast:
        embed = embed.to(cdt)
    layers = []
    for _ in range(cfg.num_layers):
        lp = init_layer(generator, cfg, dev)
        layers.append(_cast_layer(lp, cdt) if cast else lp)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": L.init_rmsnorm(d, dev),
        "head": {
            "w": L.normal_init(generator, (vp, d), d, device=dev),
            "b": torch.zeros((vp,), dtype=torch.float32, device=dev),
        },
    }


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

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Decode cache, zeros: k and v of shape (L, B, max_len, KV, hd) in
    ``dtype`` for attention; conv (L, B, W-1, di + 2N) and state
    (L, B, H, N, P) for an SSM branch, float32 whatever ``dtype`` is, as
    the reference's."""
    dev = device_lib.resolve(device)
    cache: Dict[str, torch.Tensor] = {}
    if _has_attn(cfg):
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if _has_ssm(cfg):
        cache.update(_ssm_leaves(cfg, batch, dev))
    return cache


def _ssm_leaves(cfg: ModelConfig, rows: int, dev) -> Dict[str, torch.Tensor]:
    conv, state = ssm_lib.init_ssm_cache(cfg, rows, device=dev)
    ell = cfg.num_layers
    return {"conv": conv[None].repeat(ell, *([1] * conv.ndim)),
            "state": state[None].repeat(ell, *([1] * state.ndim))}


def init_paged_cache(cfg: ModelConfig, n_lanes: int, n_pages: int, page_len: int,
                     dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Paged decode cache: the attention K/V live in a shared arena of
    ``n_pages`` physical pages of ``page_len`` positions (the allocator's
    sink page included), k and v of shape (L, n_pages, page_len, KV, hd),
    zeros, addressed through per-lane page tables. An SSM branch's conv and
    state have no sequence dimension to page: they stay lane-indexed,
    (L, n_lanes, ...), float32."""
    dev = device_lib.resolve(device)
    cache: Dict[str, torch.Tensor] = {}
    if _has_attn(cfg):
        shape = (cfg.num_layers, n_pages, page_len, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    if _has_ssm(cfg):
        cache.update(_ssm_leaves(cfg, n_lanes, dev))
    return cache


# ---------------------------------------------------------------------------
# Block body
# ---------------------------------------------------------------------------

def _block(layer_params, cfg: ModelConfig, h, positions, window: int,
           cache_l, cache_pos, attn_impl: str = "kernel", decode: bool = False,
           mask_pos=None):
    """One decoder block. Returns (h, metrics); a cache's leaves are
    written in place."""
    metrics: Dict[str, torch.Tensor] = {}
    mix_in = L.rmsnorm(layer_params["norm_mix"], h)
    mix_out = None
    if _has_attn(cfg):
        kvc = (cache_l["k"], cache_l["v"]) if cache_l is not None else None
        mix_out, _ = L.attention(layer_params["attn"], cfg, mix_in, positions, window,
                                 kv_cache=kvc, cache_pos=cache_pos, impl=attn_impl,
                                 mask_pos=mask_pos)
    if _has_ssm(cfg):
        sc = (cache_l["conv"], cache_l["state"]) if cache_l is not None else None
        s_out, (conv, state) = ssm_lib.ssm_block(layer_params["ssm"], cfg, mix_in,
                                                 cache=sc, decode=decode)
        if cache_l is not None:
            cache_l["conv"].copy_(conv)
            cache_l["state"].copy_(state)
        # hymba: the mean of the parallel branches, in the branches' dtype.
        mix_out = s_out if mix_out is None else (mix_out + s_out) / 2.0
    h = h + mix_out.to(h.dtype)

    if cfg.is_moe or cfg.d_ff > 0:
        ffn_in = L.rmsnorm(layer_params["norm_ffn"], h)
        if cfg.is_moe:
            f_out, moe_metrics = moe_lib.moe_ffn(layer_params["moe"], cfg, ffn_in)
            metrics.update(moe_metrics)
        else:
            f_out = L.mlp(layer_params["mlp"], ffn_in, L._dtype(cfg))
        h = h + f_out.to(h.dtype)
    return h, metrics


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embedding in ``cfg.dtype``; a vision frontend's precomputed
    (B, n_vis, d) embeddings are prepended (the modality stub)."""
    cdt = L._dtype(cfg)
    h = params["embed"][tokens].to(cdt)
    if vision_embeds is not None:
        h = torch.cat([vision_embeds.to(device=h.device, dtype=cdt), h], dim=1)
    return h


def _check_positions(positions: torch.Tensor, cache_pos, bsz: int, s: int) -> None:
    """The kernel masks by index: explicit positions may reach it only where
    their first stream is ``cache_pos + arange(S)`` row by row. Read on the
    host; anything else raises."""
    p0 = L.to_host(positions if positions.ndim == 2 else positions[0])
    cp = np.broadcast_to(L.to_host(0 if cache_pos is None else cache_pos)
                         .astype(np.int64).reshape(-1), (bsz,))
    if p0.shape != (bsz, s) or not (p0 == cp[:, None] + np.arange(s)).all():
        raise ValueError(
            "flash_attention masks by index: explicit positions must have "
            "positions[0] == cache_pos + arange(S) in every row; pass "
            "attn_impl='plain' (no cache) for other positions")


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            cache: Optional[Dict[str, torch.Tensor]] = None,
            cache_pos=None, inputs_embeds: Optional[torch.Tensor] = None,
            attn_impl: str = "kernel", page_table=None,
            write_mask=None) -> Tuple[torch.Tensor, Any, Dict[str, torch.Tensor]]:
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

    ``metrics``: a mixture-of-experts model's ``moe_dropped_frac`` and
    ``moe_router_entropy``, each the mean over layers; otherwise empty.
    """
    h = (inputs_embeds if inputs_embeds is not None
         else embed_inputs(params, cfg, tokens, vision_embeds))
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
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    layer_metrics = []
    for i, layer_params in enumerate(params["layers"]):
        cache_l = None if cache is None else {k: leaf[i] for k, leaf in cache.items()}
        window = cfg.window_for_layer(i)
        if remat:
            h, metrics = checkpoint_lib.checkpoint(
                lambda lp, x, w=window: _block(lp, cfg, x, positions, w, None, base,
                                               attn_impl, mask_pos=mask_pos),
                layer_params, h, use_reentrant=False)
        else:
            h, metrics = _block(layer_params, cfg, h, positions, window, cache_l, base,
                                attn_impl, decode=decode, mask_pos=mask_pos)
        layer_metrics.append(metrics)
    h = L.rmsnorm(params["final_norm"], h)
    metrics = {k: torch.stack([m[k] for m in layer_metrics]).mean()
               for k in layer_metrics[0]} if layer_metrics else {}
    return h, cache, metrics
