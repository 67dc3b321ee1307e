"""Core layers: RMSNorm, RoPE, GQA attention (SWA / softcap), SwiGLU.

Parameter-dict style, as the JAX package's ``repro.models.layers``: each
layer is an ``init_*`` returning a dict of tensors under the reference's key
names plus a function on tensors. Attention has two implementations, chosen
by the caller: ``impl="kernel"`` (serving) runs ``ops.flash_attention`` (the
forward-only CUDA kernel on the card, its plain version on the CPU);
``impl="plain"`` (training, evaluation, feature collection) is the
reference's own attention in plain torch, differentiable under autograd.
Both take float32 logits and softmax; bulk matmuls honour ``cfg.dtype``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal_init(generator: torch.Generator, shape, fan_in: int,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """N(0, 1 / fan_in) drawn on ``generator``'s device, moved to ``device``
    (default: the generator's)."""
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32) / math.sqrt(float(max(fan_in, 1)))
    return w.to(device=device or generator.device, dtype=dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, device=None):
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}   # (1 + scale) * x-hat


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + params["scale"])
    return out.to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device)
                            / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd). positions: (B, S). Computed in float32 and cast
    back to x's dtype. The reference's M-RoPE sections (qwen2-vl) wait for
    the vision slice (ROADMAP item 9)."""
    half = x.shape[-1] // 2
    inv_freq = rope_frequencies(x.shape[-1], theta, device=x.device)    # (half,)
    angles = positions.float()[..., None] * inv_freq          # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]                    # (B,S,1,half)
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_attention(generator: torch.Generator, cfg: ModelConfig, device=None):
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    return {
        "wq": normal_init(generator, (d, h, hd), d, device=device),
        "wk": normal_init(generator, (d, kv, hd), d, device=device),
        "wv": normal_init(generator, (d, kv, hd), d, device=device),
        "wo": normal_init(generator, (h, hd, d), h * hd, device=device),
    }


def causal_window_mask(seq_len: int, window: int, device=None) -> torch.Tensor:
    """(S, S) bool validity mask: causal, optionally sliding-window."""
    pos = torch.arange(seq_len, device=device)
    delta = pos[:, None] - pos[None, :]
    valid = delta >= 0
    if window > 0:
        valid &= delta < window
    return valid


def _project(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """(B, S, d) @ (d, heads, hd) -> (B, S, heads, hd)."""
    d, heads, hd = w.shape
    return (x @ w.to(dtype).reshape(d, heads * hd)).view(*x.shape[:2], heads, hd)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap and cap > 0.0 else x


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: ModelConfig, window: int) -> torch.Tensor:
    """Causal self-attention as the reference computes it in training
    (``src/repro/models/layers.py:238-264``), under autograd.

    q: (B, S, H, hd) already scaled by 1/sqrt(hd) in ``cfg.dtype``; k, v:
    (B, S, KV, hd). Logits in ``cfg.softmax_dtype`` (float32), the softcap,
    masked entries at -1e4 under a softcap and at finfo.min / 2 otherwise,
    the softmax (without the max subtraction under a softcap, whose logits
    are bounded), probabilities rounded to ``cfg.dtype`` before P·V.
    Returns (B, S, H, hd) in ``cfg.dtype``.
    """
    b, s, h, hd = q.shape
    groups = h // k.shape[2]
    cdt, sm_dt = _dtype(cfg), getattr(torch, cfg.softmax_dtype)

    def heads_first(x):                        # (B, S, H, hd) -> (B·H, S, hd)
        return x.transpose(1, 2).reshape(b * h, s, hd)

    kx = k.repeat_interleave(groups, dim=2) if groups > 1 else k
    vx = v.repeat_interleave(groups, dim=2) if groups > 1 else v
    # bmm returns a tensor of its own (einsum and matmul return views of
    # theirs), and no backward needs the logits' values, so the mask is
    # filled in place: no copy of the (B·H, S, S) logits in the forward or
    # the backward.
    logits = torch.bmm(heads_first(q.to(sm_dt)), heads_first(kx.to(sm_dt)).transpose(1, 2))
    cap = cfg.attn_logit_softcap
    logits = _softcap(logits, cap)
    capped = cap > 0.0
    neg = -1e4 if capped else torch.finfo(sm_dt).min / 2
    logits.masked_fill_(~causal_window_mask(s, window, device=q.device), neg)
    if capped:
        ex = torch.exp(logits)
        probs = (ex / ex.sum(dim=-1, keepdim=True)).to(cdt)
    else:
        probs = torch.softmax(logits, dim=-1).to(cdt)
    out = torch.bmm(probs, heads_first(vx.to(cdt)))
    return out.view(b, h, s, hd).transpose(1, 2)


def attention(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
              window: int,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos=None, impl: str = "kernel"):
    """GQA attention with causal + per-layer sliding-window mask + softcap.

    Training/prefill: ``kv_cache is None`` → self-attention over x; the
    freshly computed (k, v) are returned as the new cache.
    Cache: ``kv_cache=(k, v)`` of shape (B, S_max, KV, hd) and ``cache_pos``
    the scalar position of x's first token (a Python int or a 0-dim tensor):
    x's k/v are written into the cache IN PLACE at [cache_pos, cache_pos + S)
    and the returned cache is the same pair of tensors. Prefill is
    ``cache_pos=0`` with S the prompt length, decode S = 1. Attention then
    runs over the cache sliced to [0, cache_pos + S): with that slice the
    kernel's end-aligned query positions are x's absolute positions, so its
    mask is the reference's ``q_pos - k_pos`` mask.

    ``window`` is the layer's Python int (0 = full attention). The
    reference's per-row ``cache_pos`` (slotted decode) and paged
    ``page_table`` branches belong to the serving engine (ROADMAP item 11).

    Numerics follow the reference: q, k, v in ``cfg.dtype``, RoPE in float32,
    q scaled by 1/sqrt(hd) in ``cfg.dtype`` before the logits (the kernel is
    called with ``scale=1.0``), float32 logits, softcap and softmax. The
    reference rounds the probabilities to ``cfg.dtype`` before P·V; the
    kernel keeps them in float32, as the Pallas kernel does.

    ``impl="plain"`` runs :func:`plain_attention` instead of the kernel: the
    reference's training math, differentiable, for self-attention without a
    cache. The kernel is forward-only and refuses inputs that need
    gradients.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cdt = _dtype(cfg)

    q = _project(x, params["wq"], cdt)
    k = _project(x, params["wk"], cdt)
    v = _project(x, params["wv"], cdt)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if impl not in ("kernel", "plain"):
        raise ValueError(f"attention impl must be 'kernel' or 'plain', got {impl!r}")
    if kv_cache is None:
        k_all, v_all = k, v
        new_cache = (k, v)
    elif impl == "plain":
        raise ValueError("the plain attention is self-attention without a cache")
    else:
        if isinstance(cache_pos, torch.Tensor) and cache_pos.dim() > 0:
            raise NotImplementedError(
                "per-row cache_pos (slotted decode) belongs to the serving "
                "engine, ROADMAP item 11")
        start = int(cache_pos)
        ck, cv = kv_cache
        end = start + s
        if end > ck.shape[1]:
            raise ValueError(f"cache holds {ck.shape[1]} positions, the step "
                             f"writes up to {end}")
        ck[:, start:end] = k.to(ck.dtype)
        cv[:, start:end] = v.to(cv.dtype)
        k_all, v_all = ck[:, :end], cv[:, :end]
        new_cache = (ck, cv)

    # Fold the 1/sqrt(hd) scale into q, rounded to cfg.dtype as the reference.
    scale = (1.0 / torch.sqrt(torch.tensor(float(hd)))).to(cdt).item()
    q = q * scale
    if impl == "plain":
        out = plain_attention(q, k_all, v_all, cfg, window).reshape(b, s, h * hd)
    else:
        out = ops.flash_attention(q.transpose(1, 2), k_all.transpose(1, 2),
                                  v_all.transpose(1, 2), causal=True, window=window,
                                  softcap=cfg.attn_logit_softcap, scale=1.0)
        out = out.transpose(1, 2).reshape(b, s, h * hd)
    out = out @ params["wo"].to(cdt).reshape(h * hd, -1)
    return out, new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(generator: torch.Generator, d: int, d_ff: int, device=None):
    return {
        "w_gate": normal_init(generator, (d, d_ff), d, device=device),
        "w_up": normal_init(generator, (d, d_ff), d, device=device),
        "w_down": normal_init(generator, (d_ff, d), d_ff, device=device),
    }


def mlp(params, x: torch.Tensor, dtype) -> torch.Tensor:
    g = x @ params["w_gate"].to(dtype)
    u = x @ params["w_up"].to(dtype)
    return (F.silu(g) * u) @ params["w_down"].to(dtype)
