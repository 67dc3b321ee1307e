"""LM output head: the paper's adversarial softmax approximation on the
decoder's final hidden state. Training: every head kind's loss under
autograd (:func:`lm_head_loss`, the softmax baseline over the padded,
softcapped full logits) and the sampled kinds' loss with analytic sparse
gradients (:func:`lm_sparse_head_loss`, the ``sampled_head_loss`` kernel on
the card). Serving: Eq. 5 bias removal, dense over the vocabulary or over
the candidates of a beam search down the generator tree.

The generator feature x_gen (paper: PCA of the input) is a fixed linear
projection of the (stop-gradient) final hidden state — ``LMHeadState.proj``.
Padded vocab rows are masked out of full-logit paths; the samplers only
draw real labels. On the card the dense path runs the ``tree_logprob_all``
kernel (``tree.log_prob_all``) and the beam path scores its candidates with
the ``gather_scores`` kernel (``heads.kernel_scores``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.core import heads as heads_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.heads import Generator, HeadConfig, HeadParams
from repro_torch.models.config import ModelConfig


class LMHeadState(NamedTuple):
    """Non-trainable head state (generator + feature projection)."""
    gen: Generator
    proj: Optional[torch.Tensor] = None    # (d_model, k)


def default_head_state(generator: torch.Generator, cfg: ModelConfig, kind: str,
                       device="cuda") -> LMHeadState:
    """Head state before any generator fitting: random tree / uniform freq,
    drawn on ``generator``'s device and put on ``device``."""
    dev = device_lib.resolve(device)
    proj = torch.randn((cfg.d_model, cfg.gen_feature_dim), generator=generator,
                       device=generator.device) / cfg.d_model ** 0.5
    gen = Generator()
    if kind in ("adversarial_ns", "nce", "sampled_softmax"):
        gen = Generator(tree=tree_lib.init_tree(
            generator, cfg.vocab_size, cfg.gen_feature_dim, scale=0.05, device=dev))
    elif kind == "freq_ns":
        gen = heads_lib.make_freq_generator(
            torch.ones((cfg.vocab_size,), dtype=torch.float32), device=dev)
    return LMHeadState(gen=gen, proj=proj.to(dev))


def head_config(cfg: ModelConfig, kind: str, n_neg: int = 1,
                reg: float = 0.0) -> HeadConfig:
    return HeadConfig(num_labels=cfg.vocab_size, kind=kind, n_neg=n_neg, reg=reg)


def gen_features(state: LMHeadState, h: torch.Tensor) -> torch.Tensor:
    """x_gen = stop_grad(h) @ proj — the O(d·k) generator feature."""
    return h.detach().float() @ state.proj


def _softcap_score_fn(cap: float, base: heads_lib.ScoreFn) -> heads_lib.ScoreFn:
    def fn(params: HeadParams, h, ids):
        s = base(params, h, ids)
        return cap * torch.tanh(s / cap)
    return fn


def serving_score_fn(cfg: ModelConfig, mesh=None) -> heads_lib.ScoreFn:
    """Candidate scorer of the beam path, final softcap included: the
    ``gather_scores`` kernel on the card (its plain version on the CPU).
    With ``mesh`` the head's params are this rank's rows and the scorer is
    ``parallel.collectives.sharded_candidate_scores``: each ``model`` rank
    scores the candidates it owns, one ``all_reduce`` of the scores."""
    base = heads_lib.kernel_scores
    if mesh is not None:
        from repro_torch.parallel.collectives import sharded_candidate_scores

        def base(p: HeadParams, hh, ids):
            return sharded_candidate_scores(mesh, p.w, p.b, hh, ids)
    if cfg.final_logit_softcap:
        return _softcap_score_fn(cfg.final_logit_softcap, base)
    return base


def masked_full_logits(cfg: ModelConfig, params: HeadParams, h: torch.Tensor,
                       lo: int = 0) -> torch.Tensor:
    """(…, V_pad) logits with padded rows masked and final softcap applied;
    with ``params`` the rows [lo, lo + n) of a row-sharded head, that
    (…, n) slice (rows masked by their global index)."""
    logits = heads_lib.full_logits(params, h)
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    rows = torch.arange(lo, lo + params.w.shape[0], device=logits.device)
    return torch.where(rows < cfg.vocab_size, logits, -1e30)


def lm_head_loss(cfg: ModelConfig, hcfg: HeadConfig, params: HeadParams,
                 state: LMHeadState, h: torch.Tensor, labels: torch.Tensor,
                 generator: Optional[torch.Generator],
                 mask: Optional[torch.Tensor] = None,
                 score_fn: Optional[heads_lib.ScoreFn] = None, sampler=None,
                 u: Optional[torch.Tensor] = None):
    """Next-token loss on final hiddens h (…, d) and labels (…,), under
    autograd. Returns (loss, metrics).

    ``softmax`` is the padded, softcapped full-logit cross entropy (the
    O(K·C) baseline the paper replaces); every sampled kind goes through
    ``heads.head_loss`` with the final softcap in its score function.
    ``sampler`` overrides the proposal; negatives come from ``generator``
    or the uniforms ``u``.
    """
    x_gen = gen_features(state, h)
    if hcfg.kind == "softmax":
        logits = masked_full_logits(cfg, params, h)
        if mask is None:
            mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
        logz = torch.logsumexp(logits, dim=-1)
        pos = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        denom = mask.sum().clamp(min=1.0)
        loss = ((logz - pos) * mask).sum() / denom
        return loss, {"pos_score": (pos.detach() * mask).sum() / denom}
    if score_fn is None:
        score_fn = (_softcap_score_fn(cfg.final_logit_softcap, heads_lib.candidate_scores)
                    if cfg.final_logit_softcap else heads_lib.candidate_scores)
    return heads_lib.head_loss(hcfg, params, state.gen, h, x_gen, labels, generator,
                               score_fn=score_fn, mask=mask, sampler=sampler, u=u)


def lm_sparse_head_loss(cfg: ModelConfig, hcfg: HeadConfig, params: HeadParams,
                        state: LMHeadState, h: torch.Tensor, labels: torch.Tensor,
                        generator: Optional[torch.Generator],
                        mask: Optional[torch.Tensor] = None, sampler=None,
                        u: Optional[torch.Tensor] = None):
    """Sampled-head loss with O(B·K·n_neg) analytic gradients: the same loss
    and metrics as :func:`lm_head_loss` (the final softcap folded into the
    coefficients), the deduped ``SparseRows`` head gradient and the trunk
    gradient ``dh`` (float32, h's shape). On the card the loss, coefficients
    and dh come from the ``sampled_head_loss`` kernel, which the port always
    takes there (the reference's ``use_kernel`` switch has no counterpart).
    Returns (loss, metrics, sparse, dh)."""
    x_gen = gen_features(state, h)
    return heads_lib.sparse_head_loss(
        hcfg, params, state.gen, h.detach(), x_gen, labels.long(), generator,
        mask=mask, softcap=cfg.final_logit_softcap, sampler=sampler, u=u)


def _rank_uniforms(hcfg: HeadConfig, sampler, generator: torch.Generator,
                   global_shape: Tuple[int, ...], mesh, device) -> torch.Tensor:
    """The global batch's uniforms, drawn from ``generator`` (the one draw a
    one-rank step makes), and this data rank's rows of them."""
    from repro_torch.parallel import sharding
    draw = tuple(global_shape) + (hcfg.n_neg,)
    u = torch.rand(sampler.uniform_shape(draw), generator=generator,
                   device=generator.device)
    return u[sharding.batch_slice(draw[0], mesh)].to(device)


def _global_count(mask: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch's mask count (a sum over ``data``), at least 1."""
    import torch.distributed as dist
    from repro_torch.parallel import sharding
    denom = mask.float().sum().reshape(1)
    if sharding.size(mesh, "data") > 1:
        dist.all_reduce(denom, group=sharding.group(mesh, "data"))
    return denom[0].clamp(min=1.0)


def sharded_label_logprob(mesh, scores: torch.Tensor, labels: torch.Tensor, lo: int):
    """The vocab-parallel log-softmax at the labels: scores (N, V/tp) are a
    rank's rows ``[lo, lo + V/tp)`` of the vocabulary, labels (N,) global.
    The maximum (MAX over ``model``), the sum of exponentials and the
    label's score from its owner (SUMs over ``model``, their gradients the
    identity: ``collectives.sum_over_model``). Returns (log p (N,), the
    label's score (N,)). Under autograd the scores' gradient is the local
    softmax minus the owned one-hot, scaled by the incoming gradient; the
    maximum carries none (it cancels)."""
    import torch.distributed as dist
    from repro_torch.parallel import collectives, sharding
    top = scores.detach().amax(dim=-1)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=sharding.group(mesh, "model"))
    total = collectives.sum_over_model(mesh, torch.exp(scores - top[:, None]).sum(dim=-1))
    local = labels.long() - lo
    mine = (local >= 0) & (local < scores.shape[-1])
    pos = torch.gather(scores, -1, local.clamp(0, scores.shape[-1] - 1)[:, None])[:, 0]
    pos = collectives.sum_over_model(mesh, torch.where(mine, pos, torch.zeros_like(pos)))
    return pos - (top + torch.log(total)), pos


def _sharded_score_fn(cfg: ModelConfig, mesh) -> heads_lib.ScoreFn:
    """:func:`heads.candidate_scores` on a row-sharded head under
    autograd: the candidates' rows gathered from their owners
    (``collectives.sharded_gather_rows``, whose backward writes the owned
    rows' gradient and sums nothing over ``model``), the final softcap
    applied."""
    from repro_torch.parallel.collectives import sharded_gather_rows

    def base(p: HeadParams, hh, ids):
        w = sharded_gather_rows(mesh, p.w, ids).float()
        return (torch.einsum("...nk,...k->...n", w, hh.float())
                + sharded_gather_rows(mesh, p.b, ids).float())
    if cfg.final_logit_softcap:
        return _softcap_score_fn(cfg.final_logit_softcap, base)
    return base


def lm_sharded_dense_loss(cfg: ModelConfig, hcfg: HeadConfig, params: HeadParams,
                          state: LMHeadState, h: torch.Tensor, labels: torch.Tensor,
                          generator: Optional[torch.Generator], mesh,
                          global_shape: Tuple[int, ...],
                          mask: Optional[torch.Tensor] = None, sampler=None):
    """:func:`lm_head_loss` of one rank of a ``("data", "model")`` mesh,
    under autograd: h and labels are its ``data`` slice of a global batch
    whose labels have ``global_shape``, ``params`` its rows of the head;
    the loss and metrics are its share of the global means (normalised by
    the global mask count). Returns (loss, metrics).

    ``softmax``: each ``model`` rank scores its rows of the vocabulary and
    :func:`sharded_label_logprob` combines them; a rank's gradient of ``h``
    is then a partial sum over its rows, so ``h`` enters through
    ``collectives.copy_to_model``. The sampled kinds draw the global
    uniforms (:func:`lm_sharded_head_loss`) and score the candidates on
    rows gathered from their owners: every rank computes the whole loss
    alike, so the gradients of ``h`` and of the gathered rows are whole on
    every rank and nothing is summed over ``model``."""
    from repro_torch.core import samplers as samplers_lib
    from repro_torch.parallel import collectives, sharding
    labels = labels.long()
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    denom = _global_count(mask, mesh)
    if hcfg.kind == "softmax":
        lo, _ = sharding.row_range(cfg.padded_vocab, mesh)
        logits = masked_full_logits(cfg, params, collectives.copy_to_model(mesh, h), lo)
        logp, pos = sharded_label_logprob(mesh, logits.reshape(-1, logits.shape[-1]),
                                          labels.reshape(-1), lo)
        m = mask.reshape(-1).float()
        return ((-logp * m).sum() / denom,
                {"pos_score": (pos.detach() * m).sum() / denom})
    if sampler is None:
        sampler = samplers_lib.sampler_from_config(hcfg, state.gen)
    u = _rank_uniforms(hcfg, sampler, generator, global_shape, mesh, h.device)
    return heads_lib.head_loss(hcfg, params, state.gen, h, gen_features(state, h), labels,
                               None, score_fn=_sharded_score_fn(cfg, mesh), mask=mask,
                               sampler=sampler, u=u, denom=denom)


def lm_sharded_head_loss(cfg: ModelConfig, hcfg: HeadConfig, params: HeadParams,
                         state: LMHeadState, h: torch.Tensor, labels: torch.Tensor,
                         generator: torch.Generator, mesh, global_shape: Tuple[int, ...],
                         mask: Optional[torch.Tensor] = None, sampler=None):
    """:func:`lm_sparse_head_loss` of one rank of a ``("data", "model")``
    mesh: h and labels are its ``data`` slice of a global batch whose
    labels have ``global_shape``, ``params`` its rows of the head.

    The uniforms are the global batch's, drawn from ``generator`` (the one
    draw a one-rank step makes), and the rank keeps its rows. Its candidate
    rows are gathered from their owners into a compact (U, K) table
    (``collectives.sharded_gather_rows``) and the ``sampled_head_loss``
    kernel runs on it with the ids remapped; the ``SparseRows`` come back in
    global ids. The loss, the metrics, the coefficients and dh are
    normalised by the global mask count, so each data rank returns its
    share of the global values (their sum over ``data`` is the one-rank
    step's). Returns (loss, metrics, SparseRows, dh)."""
    from repro_torch.core import samplers as samplers_lib
    from repro_torch.optim.sparse import SparseRows, unique_rows
    from repro_torch.parallel import collectives
    x_gen = gen_features(state, h)
    labels = labels.long()
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    if sampler is None:
        sampler = samplers_lib.sampler_from_config(hcfg, state.gen)
    u = _rank_uniforms(hcfg, sampler, generator, global_shape, mesh, h.device)
    ids, slot_logp, _ = heads_lib._sample_candidates(hcfg, state.gen, x_gen, labels, None,
                                                     sampler=sampler, u=u)
    uniq, inv = unique_rows(ids, cfg.padded_vocab)
    table = HeadParams(w=collectives.sharded_gather_rows(mesh, params.w, uniq),
                       b=collectives.sharded_gather_rows(mesh, params.b, uniq))
    loss, metrics, rows, dh = heads_lib.sparse_candidate_loss(
        hcfg, table, h.detach(), inv.reshape(ids.shape), slot_logp, mask=mask,
        softcap=cfg.final_logit_softcap, denom=_global_count(mask, mesh))
    return loss, metrics, SparseRows(ids=uniq[rows.ids], dw=rows.dw, db=rows.db), dh


def lm_predictive_topk(cfg: ModelConfig, hcfg: HeadConfig, params: HeadParams,
                       state: LMHeadState, h: torch.Tensor, topk: int,
                       beam: Optional[int] = None,
                       score_fn: Optional[heads_lib.ScoreFn] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``topk`` debiased (scores, labels) without the O(C) logits matmul.

    Adversarial head: beam search over the generator tree proposes ``beam``
    candidates, only those are scored (softcap applied per candidate, padded
    vocab rows unreachable since candidates are real labels), Eq. 5 debias
    on the candidate set. ``score_fn`` defaults to :func:`serving_score_fn`.
    Other heads fall back to the dense path + top_k.
    """
    if hcfg.kind == "adversarial_ns" and state.gen.tree is not None:
        x_gen = gen_features(state, h)
        if score_fn is None:
            score_fn = serving_score_fn(cfg)
        return heads_lib.predictive_topk(hcfg, params, state.gen, h, x_gen,
                                         topk, beam=beam, score_fn=score_fn)
    scores = lm_predictive_scores(cfg, hcfg, params, state, h)
    return torch.topk(scores, topk, dim=-1)


def lm_predictive_scores(cfg: ModelConfig, hcfg: HeadConfig, params: HeadParams,
                         state: LMHeadState, h: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """Full-vocab scores with Eq. 5 bias removal (adversarial head).

    With ``params`` the rows [lo, lo + n) of a row-sharded head, the
    (…, n) slice of the scores: the padding mask and the debias are taken
    at the global rows (the tree's pass runs whole and is sliced)."""
    hi = lo + params.w.shape[0]
    scores = masked_full_logits(cfg, params, h, lo)
    if not hcfg.debias:
        return scores
    pad = cfg.padded_vocab - cfg.vocab_size
    if hcfg.kind == "adversarial_ns" and state.gen.tree is not None:
        log_pn = tree_lib.log_prob_all(state.gen.tree, gen_features(state, h))
        return scores + torch.nn.functional.pad(log_pn, (0, pad))[..., lo:hi]
    if hcfg.kind == "freq_ns":
        return scores + torch.nn.functional.pad(state.gen.freq_log, (0, pad))[lo:hi]
    return scores


def sharded_argmax(mesh, scores: torch.Tensor, lo: int) -> torch.Tensor:
    """The global argmax over ``model`` of row-sliced scores (…, V/tp)
    starting at global row ``lo``: each rank's (max, index) are gathered
    and the largest wins, ties to the lowest index as ``torch.argmax``
    breaks them, so the result equals the one-rank argmax."""
    import torch.distributed as dist
    from repro_torch.parallel import sharding
    idx = scores.argmax(dim=-1)
    val = torch.gather(scores, -1, idx[..., None])[..., 0]
    g = sharding.group(mesh, "model")
    n = dist.get_world_size(g)
    vals = [torch.empty_like(val) for _ in range(n)]
    idxs = [torch.empty_like(idx) for _ in range(n)]
    dist.all_gather(vals, val.contiguous(), group=g)
    dist.all_gather(idxs, (idx + lo).contiguous(), group=g)
    vals, idxs = torch.stack(vals, -1), torch.stack(idxs, -1)
    best = vals.argmax(dim=-1, keepdim=True)   # first max: the lowest rank's
    return torch.gather(idxs, -1, best)[..., 0]
