"""Core layers: RMSNorm, (M-)RoPE, GQA attention (SWA / softcap), SwiGLU.

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
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal_init(generator: torch.Generator, shape, fan_in: int,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """N(0, 1 / fan_in) drawn on ``generator``'s device, moved to ``device``
    (default: the generator's). On the meta device nothing is drawn: an
    empty meta tensor of the shape (:mod:`repro_torch.models.specs`)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x: (B, S, H, hd). positions: (B, S), or (n_sections, B, S) for M-RoPE.
    Computed in float32 and cast back to x's dtype.

    M-RoPE (qwen2-vl): the rotary half-dims are split into ``sections``
    (temporal/height/width), each rotated by its own position stream. With
    identical streams this is standard RoPE, bit for bit.
    """
    half = x.shape[-1] // 2
    inv_freq = rope_frequencies(x.shape[-1], theta, device=x.device)    # (half,)
    if positions.ndim == 2:
        pos = positions.float()[..., None]                    # (B, S, 1)
    else:
        sections = sections or (half,)
        if sum(sections) != half:
            raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
        sec_id = torch.repeat_interleave(
            torch.arange(len(sections), device=x.device),
            torch.tensor(sections, device=x.device))           # (half,)
        pos = positions[sec_id].permute(1, 2, 0).float()      # (B, S, half)
    angles = pos * inv_freq                                   # (B, S, half)
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


def position_mask(pos: torch.Tensor, window: int) -> torch.Tensor:
    """(B, S, S) bool validity mask from explicit (B, S) positions, as the
    reference masks self-attention: 0 <= q_pos - k_pos (< window if set)."""
    delta = pos[:, :, None] - pos[:, None, :]
    valid = delta >= 0
    if window > 0:
        valid &= delta < window
    return valid


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    cfg: ModelConfig, window: int,
                    mask_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
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
    if mask_pos is None:
        logits.masked_fill_(~causal_window_mask(s, window, device=q.device), neg)
    else:
        logits.view(b, h, s, s).masked_fill_(~position_mask(mask_pos, window)[:, None], neg)
    if capped:
        ex = torch.exp(logits)
        probs = (ex / ex.sum(dim=-1, keepdim=True)).to(cdt)
    else:
        probs = torch.softmax(logits, dim=-1).to(cdt)
    out = torch.bmm(probs, heads_first(vx.to(cdt)))
    return out.view(b, h, s, hd).transpose(1, 2)


class CacheIndex(NamedTuple):
    """The indices of one step through the serving engine's caches: built on
    the host from ``cache_pos`` (B,) (and a page table), copied to the device
    in one transfer, and shared by every layer of the step.

    - ``positions`` (B, S) int64: token s of row b sits at cache_pos[b] + s.
    - ``write_rows`` (B·S,) int64: the flat cache row each token's K/V goes
      to: ``b * S_max + pos`` in a slotted (B, S_max, KV, hd) cache, the
      arena row ``page * page_len + pos % page_len`` in a paged one.
    - ``kv_lens`` (B,) int32: each row's keys after the write,
      cache_pos + S; ``max_kv_len`` is their largest, a host int.
    - ``page_table`` (B, max_pages) int32, or None for a slotted cache.
    """
    positions: torch.Tensor
    write_rows: torch.Tensor
    kv_lens: torch.Tensor
    page_table: Optional[torch.Tensor]
    max_kv_len: int


def to_host(a) -> np.ndarray:
    """A numpy copy of an array-like: a tensor (on any device), an array or
    a list."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def cache_index(cache_pos, batch: int, s: int, device, *, s_max: Optional[int] = None,
                page_table=None, write_mask=None, page_len: Optional[int] = None,
                sink: Optional[int] = None) -> CacheIndex:
    """Build a :class:`CacheIndex` on the host and copy it to ``device``
    once. ``cache_pos`` is a scalar or (B,) (numpy, a list or a tensor,
    read to the host if it lies on the card).

    Slotted (no ``page_table``): a (B, ``s_max``, KV, hd) cache, S == 1, as
    the reference asserts; a position at or past ``s_max`` raises (the
    reference's scatter would drop it; here it would be a device fault).
    Paged: ``page_table`` (B, max_pages), arena pages of ``page_len``
    positions, ``sink`` the sink page. A logical page past the table takes
    the table's last entry, as the reference's gather clamps, and positions
    where ``write_mask`` (B, S) is false write to the sink page: torch
    indexing neither clamps nor drops, so both happen here on the host.
    """
    cp = np.broadcast_to(to_host(cache_pos).astype(np.int64).reshape(-1), (batch,))
    pos = cp[:, None] + np.arange(s, dtype=np.int64)                    # (B, S)
    if page_table is None:
        if s != 1:
            raise ValueError("per-row cache_pos writes one token a row (S == 1)")
        if (cp < 0).any() or (cp >= s_max).any():
            raise ValueError(f"cache_pos {cp.tolist()} outside the cache's "
                             f"{s_max} positions")
        rows = np.arange(batch, dtype=np.int64)[:, None] * s_max + pos
        table = np.zeros((batch, 0), np.int64)
    else:
        table = to_host(page_table).astype(np.int64)
        if table.shape[0] != batch:
            raise ValueError(f"page table {table.shape} for a batch of {batch}")
        lp = np.minimum(pos // page_len, table.shape[1] - 1)
        pid = np.take_along_axis(table, lp, axis=1)
        if write_mask is not None:
            pid = np.where(to_host(write_mask).astype(bool), pid, sink)
        rows = pid * page_len + pos % page_len
    kv_lens = cp + s
    packed = np.concatenate([pos.reshape(-1), rows.reshape(-1), kv_lens,
                             table.reshape(-1)]).astype(np.int64)
    dev = torch.from_numpy(packed).to(device)
    n = batch * s
    pos_t, rows_t = dev[:n].view(batch, s), dev[n:2 * n]
    rest = dev[2 * n:].to(torch.int32)
    return CacheIndex(
        positions=pos_t, write_rows=rows_t, kv_lens=rest[:batch],
        page_table=None if page_table is None else rest[batch:].view(batch, -1),
        max_kv_len=int(kv_lens.max()))


def is_per_row(cache_pos) -> bool:
    """Whether ``cache_pos`` gives each row its own position: a
    :class:`CacheIndex`, or an array or tensor with a dimension."""
    return isinstance(cache_pos, CacheIndex) or getattr(cache_pos, "ndim", 0) > 0


def attention(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
              window: int,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos=None, impl: str = "kernel", page_table=None,
              write_mask=None, mask_pos: Optional[torch.Tensor] = None):
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

    ``window`` is the layer's Python int (0 = full attention).

    The serving engine's two branches, as the reference's:

    - slotted decode: ``cache_pos`` (B,), S = 1: row b writes its K/V at its
      own depth ``cache_pos[b]`` and attends over ``cache_pos[b] + 1`` keys
      (``kv_lens`` of the kernel);
    - paged: ``page_table`` (B, max_pages), the cache a pair of arenas
      (P, page_len, KV, hd) with the sink page last, S >= 1: token s of row
      b writes at logical position ``cache_pos[b] + s`` of its pages
      (``write_mask`` (B, S) false: the sink page), and the kernel reads the
      row's ``cache_pos[b] + S`` keys through the page table; no page is
      copied.

    For either, ``cache_pos`` may be a prebuilt :class:`CacheIndex`
    (``transformer.forward`` builds one per step for all layers), in which
    case ``page_table`` and ``write_mask`` are not read again. The writes go
    IN PLACE (``index_copy_``); free lanes' and padding writes land on the
    sink page, in no defined order.

    Numerics follow the reference: q, k, v in ``cfg.dtype``, RoPE in float32,
    q scaled by 1/sqrt(hd) in ``cfg.dtype`` before the logits (the kernel is
    called with ``scale=1.0``), float32 logits, softcap and softmax. The
    reference rounds the probabilities to ``cfg.dtype`` before P·V; the
    kernel keeps them in float32, as the Pallas kernel does.

    ``impl="plain"`` runs :func:`plain_attention` instead of the kernel: the
    reference's training math, differentiable, for self-attention without a
    cache. The kernel is forward-only and refuses inputs that need
    gradients.

    ``positions`` (B, S), or (n_sections, B, S) under M-RoPE, rotate q and
    k. The kernel masks by index; the plain path masks by ``mask_pos``
    (B, S) when given (explicit positions: the reference masks by
    ``positions[0]``), else by index.
    """
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    cdt = _dtype(cfg)

    q = _project(x, params["wq"], cdt)
    k = _project(x, params["wk"], cdt)
    v = _project(x, params["wv"], cdt)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    if impl not in ("kernel", "plain"):
        raise ValueError(f"attention impl must be 'kernel' or 'plain', got {impl!r}")
    paged, ragged = False, {}
    if kv_cache is None:
        k_all, v_all = k, v
        new_cache = (k, v)
    elif impl == "plain":
        raise ValueError("the plain attention is self-attention without a cache")
    elif is_per_row(cache_pos) or page_table is not None:
        ck, cv = kv_cache
        if isinstance(cache_pos, CacheIndex):
            index = cache_pos
        elif page_table is not None:
            index = cache_index(cache_pos, b, s, x.device, page_table=page_table,
                                write_mask=write_mask, page_len=ck.shape[1],
                                sink=ck.shape[0] - 1)
        else:
            index = cache_index(cache_pos, b, s, x.device, s_max=ck.shape[1])
        rows = (-1,) + tuple(ck.shape[-2:])
        ck.view(rows).index_copy_(0, index.write_rows, k.reshape(b * s, kv, hd).to(ck.dtype))
        cv.view(rows).index_copy_(0, index.write_rows, v.reshape(b * s, kv, hd).to(cv.dtype))
        k_all, v_all = ck, cv
        new_cache = (ck, cv)
        paged = index.page_table is not None
        ragged = dict(kv_lens=index.kv_lens, page_table=index.page_table,
                      max_kv_len=index.max_kv_len)
    else:
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
        out = plain_attention(q, k_all, v_all, cfg, window, mask_pos).reshape(b, s, h * hd)
    else:
        # The arenas go to the kernel as they are; (B, S, KV, hd) caches as
        # (B, KV, S, hd) views.
        if not paged:
            k_all, v_all = k_all.transpose(1, 2), v_all.transpose(1, 2)
        out = ops.flash_attention(q.transpose(1, 2), k_all, v_all, causal=True,
                                  window=window, softcap=cfg.attn_logit_softcap, scale=1.0,
                                  **ragged)
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
