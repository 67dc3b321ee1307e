"""Mamba-2 (SSD, state-space duality) block — arXiv:2405.21060. The port of
``repro.models.ssm``.

Training and prefill use the chunked SSD algorithm: within a chunk the
recurrence is a masked, decay-weighted matmul (attention-shaped); across
chunks a short loop carries the (H, N, P) state. ``ssd_sequential`` is the
step-by-step oracle of the tests; ``ssm_block(decode=True)`` is the
O(1)-per-token serving step.

Shapes: x (B,S,H,P) heads×head_dim, dt (B,S,H), A (H,) negative,
B/C (B,S,N) (single group), D (H,). State: (B,H,N,P). All float32.

Two places differ from the reference in form, not in value:
- the intra-chunk decays are masked to -inf above the diagonal *before*
  ``exp``. The reference exponentiates the whole (Q, Q) difference and then
  zeroes the upper triangle; at a chunk of 256 that difference passes 88
  above the diagonal, ``exp`` overflows to inf, and its gradient is
  0 · inf = NaN. The forward values are the same;
- the three-operand contraction of the intra-chunk output is a batched
  matmul over j of (C·Bᵀ ⊙ L) and x̄: no (B, nc, Q, Q, H, P) tensor.

On a rank's part (:func:`repro_torch.parallel.sharding.shard_train_state`) the
in-projection and the conv are whole; where ``w_out``'s rows are split over
``model`` (``ssm_inner`` divides), the rank runs SSD on its own heads when
``ssm_heads`` divides (its part of the state, as ``cache_spec`` places it),
or on all of them otherwise, and feeds its part of the gated, normed
output to its rows of ``w_out``. The gated RMSNorm normalises over all of
``ssm_inner``, so the ranks sum their squares first (one (B, S, 1)
collective); the row-parallel out-projection's partial sums are reduced
over ``model``. In training, everything a rank reads whole but uses only
in part (the block's input, ``w_in``, the conv, ``dt_bias``, ``a_log``,
``d_skip`` and the norm's scale) has a partial gradient on each rank,
summed over ``model`` in the backward pass (``collectives.copy_to_model``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch import tree_util
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dtype, normal_init, rmsnorm
from repro_torch.parallel import collectives, sharding


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_sequential(x, dt, a_neg, b_mat, c_mat, d_skip):
    """Step-by-step SSD reference (oracle for the chunked path). Returns
    (y, final_state)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    decay = torch.exp(dt * a_neg)                             # (B,S,H)
    xbar = x * dt[..., None]                                  # (B,S,H,P)
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        state = (state * decay[:, t, :, None, None]
                 + b_mat[:, t, None, :, None] * xbar[:, t, :, None, :])
        ys.append((c_mat[:, t, None, None, :] @ state)[:, :, 0])    # (B,H,P)
    y = torch.stack(ys, dim=1) + x * d_skip[None, None, :, None]
    return y, state


def ssd_chunked(x, dt, a_neg, b_mat, c_mat, d_skip, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD (the Mamba-2 training algorithm). Returns (y, state).

    Arbitrary S: the tail is padded with dt = 0 steps (decay 1, no input),
    which leave the state as it is — exact, not approximate.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if s % chunk:
        pad = chunk - s % chunk
        y, state = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
                               a_neg, F.pad(b_mat, (0, 0, 0, pad)),
                               F.pad(c_mat, (0, 0, 0, pad)), d_skip, chunk, initial_state)
        return y[:, :s], state
    nc, q = s // chunk, chunk

    da = (dt * a_neg).reshape(bsz, nc, q, h)                  # (B,nc,Q,H)
    xbar = (x * dt[..., None]).reshape(bsz, nc, q, h, p)
    bm = b_mat.reshape(bsz, nc, q, n)
    cm = c_mat.reshape(bsz, nc, q, n)

    seg = torch.cumsum(da, dim=2)                             # (B,nc,Q,H)
    # --- intra-chunk: masked decay-weighted "attention", heads first ---
    seg_h = seg.transpose(2, 3)                               # (B,nc,H,Q)
    rel = seg_h[..., :, None] - seg_h[..., None, :]           # (B,nc,H,Q,Q)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    l_mat = torch.exp(rel.masked_fill(~tri, float("-inf")))
    cb = cm @ bm.transpose(-1, -2)                            # (B,nc,Q,Q)
    xbar_h = xbar.permute(0, 1, 3, 2, 4)                      # (B,nc,H,Q,P)
    y_intra = ((cb[:, :, None] * l_mat) @ xbar_h).permute(0, 1, 3, 2, 4)   # (B,nc,Q,H,P)

    # --- chunk states ---
    decay_to_end = torch.exp(seg[:, :, -1:, :] - seg)         # (B,nc,Q,H)
    weighted = (xbar * decay_to_end[..., None]).reshape(bsz, nc, q, h * p)
    states = (bm.transpose(-1, -2) @ weighted).reshape(bsz, nc, n, h, p).transpose(2, 3)
    chunk_decay = torch.exp(seg[:, :, -1, :])                 # (B,nc,H)

    # --- inter-chunk loop (carries the state across chunks) ---
    h_prev = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
              if initial_state is None else initial_state)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                     # (B,nc,H,N,P)

    y_inter = (cm @ h_prevs.transpose(2, 3).reshape(bsz, nc, n, h * p)).reshape(
        bsz, nc, q, h, p) * torch.exp(seg)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y + x * d_skip[None, None, :, None], h_prev


# ---------------------------------------------------------------------------
# Mamba-2 block (in_proj -> conv1d -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def init_ssm_block(generator: torch.Generator, cfg: ModelConfig, device=None):
    d, di, n, h = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n

    def zeros(size):
        return torch.zeros((size,), dtype=torch.float32, device=device or generator.device)

    return {
        # in_proj -> [z (di), x (di), B (n), C (n), dt (h)]
        "w_in": normal_init(generator, (d, 2 * di + 2 * n + h), d, device=device),
        "conv_w": normal_init(generator, (cfg.ssm_conv_width, conv_dim),
                              cfg.ssm_conv_width, device=device),
        "conv_b": zeros(conv_dim),
        "a_log": zeros(h),                                    # A = -exp(a_log)
        "d_skip": zeros(h) + 1.0,
        "dt_bias": zeros(h),
        "norm": {"scale": zeros(di)},
        "w_out": normal_init(generator, (di, d), di, device=device),
    }


def _split_in(cfg: ModelConfig, proj):
    di, n = cfg.ssm_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di:di + di + 2 * n], proj[..., di + di + 2 * n:]


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv1d, width W: y_t = sum_w w[w]*x_{t-W+1+w}."""
    w, s = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = sum(pad[:, i:i + s, :] * conv_w[i] for i in range(w))
    return F.silu(out + conv_b)


def _gated_norm(params, y, z, di_range, mesh):
    """RMSNorm over all of ``ssm_inner`` of the gate ``y * silu(z)``, of
    which this rank holds the columns ``di_range`` (all of them unsplit)."""
    g = y * F.silu(z.float())
    if mesh is None or di_range is None:
        return rmsnorm(params["norm"], g)
    lo, hi = di_range
    total = collectives.norm_sum_over_model(mesh, torch.sum(g * g, dim=-1, keepdim=True))
    var = total / float(params["norm"]["scale"].shape[0])
    return g * torch.rsqrt(var + 1e-6) * (1.0 + params["norm"]["scale"][lo:hi])


def ssm_block(params, cfg: ModelConfig, x: torch.Tensor,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              decode: bool = False, mesh=None, seq: bool = False):
    """Returns (out (B,S,d), new_cache=(conv_state, ssm_state)), both cache
    leaves float32. Prefill (``decode=False``) starts from ``cache``'s state
    (zeros for a fresh cache) and returns the last ``ssm_conv_width - 1``
    pre-conv inputs as the conv state, left-padded with zeros for a prompt
    shorter than that; decode takes one token (S == 1). With a rank's part
    of the weights, ``mesh`` is the mesh they were cut on (module
    docstring). ``seq`` (sequence parallelism): x and the output are the
    rank's rows of the sequence on ``mesh``; the scan needs the whole
    sequence, so x is gathered along S on entry, a split ``w_out``'s sum is
    reduce-scattered back to the rank's rows and a whole block keeps its
    rows of the output (its leaves' gradients then partial, summed over
    ``model``). The cache is the one the unhinted block writes."""
    di, n, h, p = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    cdt = _dtype(cfg)
    if seq:
        x = collectives.gather_seq_for_model(mesh, x)
    bsz, s, _ = x.shape
    if params["w_out"].shape[0] < di:
        if not seq:
            x = collectives.copy_to_model(mesh, x)
        params = {k: v if k == "w_out" else tree_util.tree_map(
            lambda t: collectives.copy_to_model(mesh, t), v) for k, v in params.items()}
    elif seq:
        params = tree_util.tree_map(lambda t: collectives.copy_to_model(mesh, t), params)
    proj = x @ params["w_in"].to(cdt)
    z, xbc, dt_raw = _split_in(cfg, proj)
    xbc = xbc.float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a_neg = -torch.exp(params["a_log"])
    d_skip = params["d_skip"]
    width = cfg.ssm_conv_width
    # A rank's part: its rows of w_out, and its heads where they divide.
    rows = heads = None
    if params["w_out"].shape[0] < di:
        rows = sharding.row_range(di, mesh)
        if h % sharding.size(mesh, "model") == 0:
            heads = sharding.row_range(h, mesh)
            dt, a_neg, d_skip = (t[..., heads[0]:heads[1]] for t in (dt, a_neg, d_skip))
    h_l = h if heads is None else heads[1] - heads[0]
    x_cols = slice(0, di) if heads is None else slice(*rows)

    if not decode:
        conv = _causal_conv(xbc, params["conv_w"], params["conv_b"])
        xs = conv[..., x_cols].reshape(bsz, s, h_l, p)
        y, state = ssd_chunked(xs, dt, a_neg, conv[..., di:di + n], conv[..., di + n:],
                               d_skip, cfg.ssm_chunk,
                               initial_state=None if cache is None else cache[1])
        # The conv state for serving: the last (width - 1) pre-conv inputs.
        # A prompt shorter than that left-pads with zeros, the fresh
        # cache's contents at those positions.
        conv_state = F.pad(xbc, (0, 0, max(0, width - 1 - s), 0))[:, -(width - 1):, :]
    else:
        if s != 1 or cache is None:
            raise ValueError("an SSM decode step takes one token and a cache")
        conv_prev, ssm_state = cache
        taps = torch.cat([conv_prev, xbc], dim=1)             # (B, width, conv)
        conv = F.silu(torch.einsum("bwc,wc->bc", taps, params["conv_w"]) + params["conv_b"])
        xs = conv[:, x_cols].reshape(bsz, h_l, p)
        decay = torch.exp(dt[:, 0] * a_neg)                   # (B,H)
        xbar = xs * dt[:, 0, :, None]                         # (B,H,P)
        state = (ssm_state * decay[..., None, None]
                 + conv[:, None, di:di + n, None] * xbar[:, :, None, :])
        y = ((conv[:, None, None, di + n:] @ state)[:, :, 0]
             + xs * d_skip[None, :, None])[:, None]
        conv_state = taps[:, 1:, :]

    y = y.reshape(bsz, s, h_l * p)
    if rows is not None and heads is None:       # whole heads, split rows
        y = _gated_norm(params, y, z, None, None)[..., rows[0]:rows[1]]
    else:
        y = _gated_norm(params, y, z[..., x_cols], rows, mesh)
    y, w_out = y.to(cdt), params["w_out"].to(cdt)
    if rows is not None:
        out = collectives.row_parallel_sum(mesh, collectives.partial_matmul(y, w_out), cdt, seq)
    else:
        out = y @ w_out
        if seq:
            lo, hi = sharding.row_range(s, mesh)
            out = out[:, lo:hi]
    return out, (conv_state, state)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device="cuda"):
    """(conv (B, W-1, di + 2N), state (B, H, N, P)) zeros."""
    dev = device_lib.resolve(device)
    di, n = cfg.ssm_inner, cfg.ssm_state
    conv = torch.zeros((batch, cfg.ssm_conv_width - 1, di + 2 * n), dtype=dtype, device=dev)
    state = torch.zeros((batch, cfg.ssm_heads, n, cfg.ssm_head_dim), dtype=dtype, device=dev)
    return conv, state
