"""Decoder-only LM assembly: a loop over layers, embeddings, caches.

The port of ``repro.models.transformer`` for ``block="attn"`` configs without
experts (stablelm, deepseek-7b, gemma2, h2o-danube, musicgen). Parameters
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
from repro_torch.models.config import ModelConfig


def _check_block(cfg: ModelConfig) -> None:
    if cfg.block != "attn" or cfg.is_moe or cfg.d_ff <= 0:
        raise NotImplementedError(
            f"{cfg.name}: SSM, hybrid and mixture-of-experts blocks are not "
            "ported yet (ROADMAP item 9)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_layer(generator: torch.Generator, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    _check_block(cfg)
    return {
        "norm_mix": L.init_rmsnorm(cfg.d_model, device),
        "norm_ffn": L.init_rmsnorm(cfg.d_model, device),
        "attn": L.init_attention(generator, cfg, device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, device),
    }


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Dict[str, Any]:
    """Float32 parameters drawn on ``generator``'s device, put on
    ``device``: ``embed`` (V_pad, d), ``layers`` (a list of per-layer
    dicts), ``final_norm``, ``head`` {w (V_pad, d), b (V_pad,)}."""
    _check_block(cfg)
    dev = device_lib.resolve(device)
    vp, d = cfg.padded_vocab, cfg.d_model
    return {
        "embed": L.normal_init(generator, (vp, d), d, device=dev),
        "layers": [init_layer(generator, cfg, dev) for _ in range(cfg.num_layers)],
        "final_norm": L.init_rmsnorm(d, dev),
        "head": {
            "w": L.normal_init(generator, (vp, d), d, device=dev),
            "b": torch.zeros((vp,), dtype=torch.float32, device=dev),
        },
    }


def cast_params(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The parameters with the embedding and every layer's matrices cast once
    to ``cfg.dtype``, for serving; norms and the head stay float32.

    The reference keeps float32 weights and casts each to ``cfg.dtype`` at
    every use; both frameworks round float32 to bfloat16 to nearest even, so
    casting once computes the same function, and the forward's casts become
    no-ops. At h2o-danube-3-4b width, recasting at every decode step would
    move about 24 GB a step.
    """
    cdt = L._dtype(cfg)

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.to(cdt) for k, v in tree.items()}

    layers = [{**lp, "attn": cast(lp["attn"]), "mlp": cast(lp["mlp"])}
              for lp in params["layers"]]
    return {**params, "embed": params["embed"].to(cdt), "layers": layers}


# ---------------------------------------------------------------------------
# Caches (stacked over layers)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Decode cache: k and v of shape (L, B, max_len, KV, hd), zeros."""
    _check_block(cfg)
    dev = device_lib.resolve(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def init_paged_cache(cfg: ModelConfig, n_lanes: int, n_pages: int, page_len: int,
                     dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Paged decode cache: the attention K/V live in a shared arena of
    ``n_pages`` physical pages of ``page_len`` positions (the allocator's
    sink page included), k and v of shape (L, n_pages, page_len, KV, hd),
    zeros, addressed through per-lane page tables. The reference's
    lane-indexed SSM leaves wait for ROADMAP item 9; ``n_lanes`` is kept
    for its signature."""
    _check_block(cfg)
    del n_lanes
    dev = device_lib.resolve(device)
    shape = (cfg.num_layers, n_pages, page_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


# ---------------------------------------------------------------------------
# Block body
# ---------------------------------------------------------------------------

def _block(layer_params, cfg: ModelConfig, h, positions, window: int,
           cache_l, cache_pos, attn_impl: str = "kernel"):
    """One decoder block. Returns (h, new_cache_l, metrics)."""
    mix_in = L.rmsnorm(layer_params["norm_mix"], h)
    kvc = (cache_l["k"], cache_l["v"]) if cache_l is not None else None
    a_out, a_cache = L.attention(layer_params["attn"], cfg, mix_in, positions,
                                 window, kv_cache=kvc, cache_pos=cache_pos,
                                 impl=attn_impl)
    new_cache = {"k": a_cache[0], "v": a_cache[1]} if cache_l is not None else {}
    h = h + a_out.to(h.dtype)
    ffn_in = L.rmsnorm(layer_params["norm_ffn"], h)
    h = h + L.mlp(layer_params["mlp"], ffn_in, L._dtype(cfg)).to(h.dtype)
    return h, new_cache, {}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embedding in ``cfg.dtype``. Vision inputs wait for their slice."""
    if vision_embeds is not None:
        raise NotImplementedError("vision inputs are not ported yet (ROADMAP item 9)")
    return params["embed"][tokens].to(L._dtype(cfg))


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
      suffix prefill and the speculative verify step): row r's tokens take
      logical positions cache_pos[r] .. cache_pos[r]+S-1, and
      ``write_mask`` (B, S) sends padding positions' K/V to the sink page

    ``cache_pos`` is a scalar (a Python int or a 0-dim tensor) or (B,); the
    cache is written in place and returned. Positions are ``cache_pos +
    arange(S)`` per row: the kernel's mask is positional by index, so
    explicit ``positions`` (M-RoPE, vision) raise until the vision slice
    (ROADMAP item 9). For a per-row ``cache_pos`` the step's indices
    (positions, write rows, key counts, the page table) are built on the
    host and copied to the device once (:func:`layers.cache_index`); pass
    ``cache_pos`` and ``page_table`` as host arrays to keep the step free of
    device reads.

    ``inputs_embeds`` (B, S, d), already in ``cfg.dtype``, replaces the
    embedding gather: the sparse-embedding training path gathers outside
    the autograd graph and collects the rows' gradients itself.
    ``attn_impl`` is ``"kernel"`` (serving) or ``"plain"`` (training,
    see :func:`repro_torch.models.layers.attention`).
    """
    if positions is not None:
        raise NotImplementedError("explicit positions come with the vision "
                                  "slice (ROADMAP item 9)")
    h = (inputs_embeds if inputs_embeds is not None
         else embed_inputs(params, cfg, tokens, vision_embeds))
    bsz, s, _ = h.shape
    base = 0 if cache_pos is None else cache_pos
    if cache is not None and (L.is_per_row(base) or page_table is not None):
        ck = cache["k"]
        if page_table is not None:
            base = L.cache_index(base, bsz, s, h.device, page_table=page_table,
                                 write_mask=write_mask, page_len=ck.shape[2],
                                 sink=ck.shape[1] - 1)
        else:
            base = L.cache_index(base, bsz, s, h.device, s_max=ck.shape[2])
        positions = base.positions
    else:
        if isinstance(base, torch.Tensor) or isinstance(base, np.ndarray):
            if base.ndim > 0:
                raise ValueError("a per-row cache_pos needs a cache")
            base = int(base)
        positions = (base + torch.arange(s, device=h.device)).expand(bsz, s)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i, layer_params in enumerate(params["layers"]):
        cache_l = None if cache is None else {"k": cache["k"][i], "v": cache["v"][i]}
        window = cfg.window_for_layer(i)
        if remat:
            h = checkpoint_lib.checkpoint(
                lambda lp, x, w=window: _block(lp, cfg, x, positions, w, None, base,
                                               attn_impl)[0],
                layer_params, h, use_reentrant=False)
        else:
            h, _, _ = _block(layer_params, cfg, h, positions, window, cache_l, base,
                             attn_impl)
    h = L.rmsnorm(params["final_norm"], h)
    return h, cache, {}
