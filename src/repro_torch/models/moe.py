"""Mixture-of-Experts FFN: shared + fine-grained routed experts. The port of
``repro.models.moe``.

Dispatch is group-local capacity-gather (groups = batch rows): routing, the
sort and the capacity assignment happen independently per sequence. Tokens
beyond an expert's capacity in their row are dropped (standard) and counted
in the metrics. Only the expanded tokens (E, C_cap, d) are materialized,
never a one-hot (T, E, C_cap) dispatch tensor.

Covers deepseek-moe (64 routed top-6 + 2 shared, softmax -> top-k) and
mixtral (8 routed top-2, top-k -> softmax).

Where the port differs in form from the reference, each for a reason:
- the sort of each row's assignments is stable (``torch.argsort`` is not by
  default; ``jnp.argsort`` is): slots, drops, and padding never taking a
  real token's slot all follow from it;
- the combine gathers instead of scatter-adding: each token sums its ≤ k
  kept assignments in choice order. A scatter-add on the card adds with
  atomics in no fixed order; the gather gives the same bits every call;
- the reference's FSDP hints around the expert matmuls: the weights
  arrive gathered over ``data`` (``transformer.forward``), in ``cfg.dtype``
  under ``hint_gathered_weight``, so their casts here are then no-ops;
  ``hint_expert_act`` is the identity on explicit ranks
  (:mod:`repro_torch.parallel.hints`).

On a rank's part (:func:`repro_torch.parallel.sharding.shard_train_state`), read
from the weights' shapes: with the experts over ``model`` (their count
divides) the rank runs only its experts, ``[r·E/tp, (r+1)·E/tp)``, on the
slots that routing gave them; otherwise each expert's ``d_ff`` is split and
the rank runs every expert on its part of ``d_ff``; the shared experts'
``d_ff`` is split either way. Routing is whole and the same on every rank,
so every rank assigns every token alike. The combine gathers the rank's own
slots (a zero row for the rest), and one ``reduce_over_model`` sums the
routed and shared parts of every rank: the experts' down-projections write
float32 (``collectives.partial_matmul``), so the sum is rounded once.
In training, a rank's gradients of the input and of the router are partial
sums (its combine reads only its experts' slots, or its part of each
expert's output), summed over ``model`` in the backward pass
(``collectives.copy_to_model``).

Under sequence parallelism (``seq``) a rank holds S/tp rows of the
stream; the MoE, split or whole, routes the rows gathered along S
(``collectives.gather_seq_for_model``), since the capacity is per
sequence and a rank's rows alone would change the drops: the groups, the
top-k ids and the drops stay those of the unhinted run. A split MoE's sum
is reduce-scattered back to the rank's rows; a whole one keeps its rows of
the output, its weights' gradients then partial (its rows only) and summed
over ``model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import tree_util
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dtype, normal_init
from repro_torch.parallel import collectives, hints, sharding


def init_moe(generator: torch.Generator, cfg: ModelConfig, device=None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    params = {
        "router": normal_init(generator, (d, e), d, device=device),
        "w_gate": normal_init(generator, (e, d, f), d, device=device),
        "w_up": normal_init(generator, (e, d, f), d, device=device),
        "w_down": normal_init(generator, (e, f, d), f, device=device),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        params["shared"] = {
            "w_gate": normal_init(generator, (d, fs), d, device=device),
            "w_up": normal_init(generator, (d, fs), d, device=device),
            "w_down": normal_init(generator, (fs, d), fs, device=device),
        }
    return params


def _capacity(cfg: ModelConfig, group_tokens: int) -> int:
    cap = int(group_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)   # round up to 8


def _gates(cfg: ModelConfig, logits: torch.Tensor):
    """(gate values, expert ids), each (..., k), from float32 router logits:
    softmax then top-k renormalized (deepseek), or top-k then softmax
    (mixtral). ``torch.topk`` sorts descending, as ``lax.top_k``."""
    if cfg.router_norm == "softmax_topk":
        gate_vals, top_idx = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k, dim=-1)
        return gate_vals / gate_vals.sum(dim=-1, keepdim=True), top_idx
    top_logits, top_idx = torch.topk(logits, cfg.top_k, dim=-1)
    return torch.softmax(top_logits, dim=-1), top_idx


def _route(cfg: ModelConfig, params, xt: torch.Tensor):
    """xt: (G, S, d) -> (gate_vals, top_idx) each (G, S, k), + raw logits."""
    logits = xt.float() @ params["router"].float()
    gate_vals, top_idx = _gates(cfg, logits)
    return gate_vals, top_idx, logits


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor, mesh=None, seq: bool = False):
    """x: (B, S, d) -> (B, S, d), plus the metrics ``moe_dropped_frac`` (the
    share of assignments past capacity) and ``moe_router_entropy``. With a
    rank's part of the weights, ``mesh`` is the mesh they were cut on.
    ``seq``: x and the output are the rank's rows of the sequence on
    ``mesh`` (module docstring)."""
    if seq:
        x = collectives.gather_seq_for_model(mesh, x)
    bsz, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cdt = _dtype(cfg)
    cap = _capacity(cfg, s)
    dev = x.device
    e_local = params["w_gate"].shape[0]
    split = e_local < e or params["w_gate"].shape[2] < cfg.d_ff
    e_lo = sharding.rank(mesh, "model") * e_local if e_local < e else 0
    if split:
        if not seq:
            x = collectives.copy_to_model(mesh, x)
        params = {**params, "router": collectives.copy_to_model(mesh, params["router"])}
    elif seq:
        params = tree_util.tree_map(lambda t: collectives.copy_to_model(mesh, t), params)

    gate_vals, top_idx, logits = _route(cfg, params, x)
    sk = s * k
    flat_expert = top_idx.reshape(bsz, sk)                    # (B, S*k)
    flat_token = (torch.arange(sk, device=dev) // k).expand(bsz, sk)
    flat_gate = gate_vals.reshape(bsz, sk)

    order = torch.argsort(flat_expert, dim=-1, stable=True)   # per-row sort
    se = torch.gather(flat_expert, 1, order)
    stok = torch.gather(flat_token, 1, order)
    sgate = torch.gather(flat_gate, 1, order)
    # Position of each assignment within its expert (per row).
    start = torch.searchsorted(se, torch.arange(e, device=dev).expand(bsz, e).contiguous())
    pos_in_e = torch.arange(sk, device=dev) - torch.gather(start, 1, se)
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, e * cap)   # e * cap: overflow

    # The overflow slot is a real column, sliced off: nothing to drop.
    slot_token = torch.zeros((bsz, e * cap + 1), dtype=torch.int64, device=dev).scatter_(
        1, slot, stok)[:, :-1]
    slot_gate = torch.zeros((bsz, e * cap + 1), dtype=torch.float32, device=dev).scatter_(
        1, slot, torch.where(keep, sgate, 0.0))[:, :-1].reshape(bsz, e, cap)

    # This rank's experts' slots (all of them unless the experts are split).
    mine = slice(e_lo * cap, (e_lo + e_local) * cap)
    slot_token, slot_gate = slot_token[:, mine], slot_gate[:, e_lo:e_lo + e_local]
    xe = torch.gather(x, 1, slot_token[..., None].expand(bsz, e_local * cap, d))
    xe = xe.reshape(bsz, e_local, cap, d) * (slot_gate[..., None] != 0.0)
    # (B, cap) folded into one token dim: the expert matmuls are plain
    # batched GEMMs over the experts.
    xt_e = xe.transpose(0, 1).reshape(e_local, bsz * cap, d).to(cdt)
    g = hints.hint_expert_act(torch.bmm(xt_e, params["w_gate"].to(cdt)))
    u = hints.hint_expert_act(torch.bmm(xt_e, params["w_up"].to(cdt)))
    # A rank's part leaves each expert's output unrounded, for one rounding
    # after the sum over model.
    down = collectives.partial_matmul if split else torch.bmm
    yt = hints.hint_expert_act(down(F.silu(g) * u, params["w_down"].to(cdt)))  # (E_l, B*cap, d)
    ye = yt.reshape(e_local, bsz, cap, d).transpose(0, 1)
    weighted = (ye.float() * slot_gate[..., None]).reshape(bsz, e_local * cap, d)

    # Combine by gathering: assignment j of each token reads its slot's row
    # (a dropped one, or another rank's, the zero row appended at the end);
    # each token then sums its k rows in choice order.
    slot_of = torch.empty_like(slot).scatter_(1, order, slot)           # (B, S*k)
    if e_local < e:
        slot_of = slot_of - e_lo * cap
        slot_of = torch.where((slot_of >= 0) & (slot_of < e_local * cap), slot_of,
                              e_local * cap)
    rows = torch.cat([weighted, weighted.new_zeros((bsz, 1, d))], dim=1)
    picked = torch.gather(rows, 1, slot_of[..., None].expand(bsz, sk, d)).reshape(bsz, s, k, d)
    out = picked[:, :, 0]
    for j in range(1, k):
        out = out + picked[:, :, j]

    metrics = {
        "moe_dropped_frac": 1.0 - keep.float().sum() / (bsz * sk),
        "moe_router_entropy": -torch.mean(torch.sum(
            torch.softmax(logits, -1) * torch.log_softmax(logits, -1), dim=-1)),
    }

    if cfg.n_shared_experts:
        sp = params["shared"]
        xc = x.to(cdt)
        sg = xc @ sp["w_gate"].to(cdt)
        su = xc @ sp["w_up"].to(cdt)
        a, w_down = F.silu(sg) * su, sp["w_down"].to(cdt)
        out = out + (collectives.partial_matmul(a, w_down) if split else (a @ w_down).float())
    if split:
        return collectives.row_parallel_sum(mesh, out, x.dtype, seq), metrics
    if seq:
        lo, hi = sharding.row_range(s, mesh)
        out = out[:, lo:hi]
    return out.to(x.dtype), metrics


def moe_ffn_dense_oracle(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """O(T·E) reference: every token through every expert, gated, in
    float32. Validates the capacity-gather dispatch (with a capacity factor
    large enough that nothing drops)."""
    bsz, s, d = x.shape
    t, e, f = bsz * s, cfg.n_experts, cfg.d_ff
    xt = x.reshape(t, d).float()
    gate_vals, top_idx = _gates(cfg, xt @ params["router"].float())
    gates = torch.zeros((t, e), dtype=torch.float32, device=x.device).scatter_(
        1, top_idx, gate_vals)
    w_gate, w_up = params["w_gate"].float(), params["w_up"].float()
    g = (xt @ w_gate.permute(1, 0, 2).reshape(d, e * f)).view(t, e, f)
    u = (xt @ w_up.permute(1, 0, 2).reshape(d, e * f)).view(t, e, f)
    ye = torch.bmm((F.silu(g) * u).transpose(0, 1), params["w_down"].float())   # (E, T, d)
    out = torch.einsum("te,etd->td", gates, ye)
    if cfg.n_shared_experts:
        sp = params["shared"]
        sg = xt @ sp["w_gate"].float()
        su = xt @ sp["w_up"].float()
        out = out + (F.silu(sg) * su) @ sp["w_down"].float()
    return out.reshape(bsz, s, d).to(x.dtype)
