"""Plain PyTorch versions of the port's kernels (the allclose targets).

They compute in float32 and take float32 or bfloat16 tables. The kernel
wrappers send CPU tensors here; on the card only the tests and
``chip_smoke.py`` call them, to hold each kernel against its plain version.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gather_pages(arena, page_table, n_keys: int):
    """The first ``n_keys`` keys of each row, read through its page table:
    arena (P, page_len, KV, hd), page_table (B, max_pages) -> (B, KV, n_keys,
    hd). Key j of row b is arena row ``page_table[b, j // page_len] *
    page_len + j % page_len``; a logical page past the table reads its last
    entry, as the reference's gather clamps. A copy: the plain version's
    way, never the kernel's."""
    page_len = arena.shape[1]
    j = torch.arange(n_keys, device=arena.device)
    lp = (j // page_len).clamp(max=page_table.shape[1] - 1)
    rows = page_table.long()[:, lp] * page_len + j % page_len       # (B, n_keys)
    flat = arena.reshape(-1, *arena.shape[2:])                      # (P·page_len, KV, hd)
    return flat[rows].permute(0, 2, 1, 3)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float | None = None,
                        kv_lens=None, page_table=None, max_kv_len: int | None = None):
    """q: (B,H,Sq,hd); k,v: (B,KV,Skv,hd) with H % KV == 0. Returns
    (B,H,Sq,hd) in q.dtype, computed in float32.

    Positions are aligned at the END: q position i corresponds to absolute
    position (Skv - Sq + i) — the decode/prefill convention. Query head j
    reads KV head j // (H / KV). Masked logits are -1e30, so a row with no
    visible key averages V over all keys. Materializes (B,H,Sq,Skv).

    ``kv_lens`` (B,) gives row b its own key count Skv_b: its query i sits
    at Skv_b - Sq + i and keys at or past Skv_b weigh exactly 0.
    ``page_table`` (B, max_pages), with ``kv_lens``, reads the keys through
    the table: k and v are then arenas (P, page_len, KV, hd)
    (:func:`gather_pages`). ``max_kv_len`` (the largest of ``kv_lens``) is
    read from ``kv_lens`` when not given.
    """
    sq, hd = q.shape[2], q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if page_table is not None:
        if kv_lens is None:
            raise ValueError("flash_attention_ref: a page table needs kv_lens")
        n_keys = int(max_kv_len if max_kv_len is not None else kv_lens.max())
        k, v = gather_pages(k, page_table, n_keys), gather_pages(v, page_table, n_keys)
    skv, groups = k.shape[2], q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(groups, dim=1)
    vf = v.float().repeat_interleave(groups, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    lens = (torch.full((q.shape[0],), skv, device=q.device) if kv_lens is None
            else kv_lens.to(q.device).long())
    q_pos = torch.arange(sq, device=q.device) + (lens[:, None] - sq)     # (B, Sq)
    k_pos = torch.arange(skv, device=q.device)
    delta = q_pos[:, :, None] - k_pos                                   # (B, Sq, Skv)
    valid = torch.ones_like(delta, dtype=torch.bool)
    if causal:
        valid &= delta >= 0
    if window > 0:
        valid &= delta < window
    exists = (k_pos < lens[:, None])[:, None, :]                         # (B, 1, Skv)
    logits = torch.where(valid[:, None], logits, -1e30)
    logits = torch.where(exists[:, None], logits, -math.inf)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def gather_scores_ref(w, b, h, ids):
    """Sampled-head scores: w: (C,K), b: (C,), h: (T,K), ids: (T,n) ->
    (T,n) fp32."""
    rows = w[ids]                                  # (T,n,K)
    return (torch.einsum("tnk,tk->tn", rows.float(), h.float())
            + b[ids].float())


def sampled_head_loss_ref(w, b, h, ids, slot_logp, *, kind: str,
                          num_labels: int, reg: float = 0.0,
                          softcap: float = 0.0, mask_accidental: bool = True):
    """The fused sampled-loss chain, unfused: gather (materializes the
    (T, m, K) rows), einsum, per-token loss and coefficients, a second
    gather for dh. Same contract as ``ops.sampled_head_loss``: (loss_vec
    (T,), coeff (T,m), xi (T,m), dh (T,K)) float32; slot 0 is the
    positive."""
    from repro_torch.kernels.sampled_loss import loss_and_coeffs

    scores = gather_scores_ref(w, b, h, ids)
    acc_hit = ids == ids[:, :1]
    acc_hit[:, 0] = False
    loss, coeff, xi = loss_and_coeffs(
        scores, slot_logp, acc_hit, kind=kind, num_labels=num_labels,
        reg=reg, softcap=softcap, mask_accidental=mask_accidental)
    dh = torch.einsum("tn,tnk->tk", coeff, w[ids].float())
    return loss, coeff, xi, dh


def segment_stats_ref(vals, seg, num_segments: int):
    """Segment-summed statistics: vals (N,D), seg (N,) int -> (num_segments,
    D) float32. Rows whose id lies outside [0, num_segments), negatives
    included, are dropped, as ``jax.ops.segment_sum`` drops them. On the CPU
    ``index_add_`` adds the rows in order; on the card it uses atomics, whose
    order varies between runs."""
    out = torch.zeros((num_segments, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    keep = (seg >= 0) & (seg < num_segments)
    return out.index_add_(0, seg[keep], vals[keep].float())


def tree_logprob_all_ref(w, b, x):
    """Dense per-leaf tree log-probs. w: (n_nodes,k), b: (n_nodes,),
    x: (B,k) -> (B, C_pad) over leaves in natural order."""
    n_nodes = b.shape[0]
    depth = (n_nodes + 1).bit_length() - 1
    bsz = x.shape[0]
    x = x.float()
    logp = torch.zeros((bsz, 1), dtype=torch.float32, device=x.device)
    for level in range(depth):
        lo, n_lvl = (1 << level) - 1, 1 << level
        z = x @ w[lo:lo + n_lvl].float().T + b[lo:lo + n_lvl].float()
        children = torch.stack([logp + F.logsigmoid(-z),
                                logp + F.logsigmoid(z)], dim=-1)
        logp = children.reshape(bsz, 2 * n_lvl)
    return logp
