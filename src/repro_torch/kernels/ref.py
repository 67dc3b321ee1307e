"""Plain PyTorch versions of the port's kernels (the allclose targets).

They compute in float32 and take float32 or bfloat16 tables. The kernel
wrappers send CPU tensors here; on the card only the tests and
``chip_smoke.py`` call them, to hold each kernel against its plain version.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, scale: float | None = None):
    """q: (B,H,Sq,hd); k,v: (B,KV,Skv,hd) with H % KV == 0. Returns
    (B,H,Sq,hd) in q.dtype, computed in float32.

    Positions are aligned at the END: q position i corresponds to absolute
    position (Skv - Sq + i) — the decode/prefill convention. Query head j
    reads KV head j // (H / KV). Masked logits are -1e30, so a row with no
    visible key averages V over all keys. Materializes (B,H,Sq,Skv).
    """
    sq, hd = q.shape[2], q.shape[3]
    skv, groups = k.shape[2], q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.float().repeat_interleave(groups, dim=1)
    vf = v.float().repeat_interleave(groups, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)
    k_pos = torch.arange(skv, device=q.device)
    delta = q_pos[:, None] - k_pos[None, :]
    valid = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        valid &= delta >= 0
    if window > 0:
        valid &= delta < window
    logits = torch.where(valid, logits, -1e30)
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
