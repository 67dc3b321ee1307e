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


def serving_score_fn(cfg: ModelConfig) -> heads_lib.ScoreFn:
    """Candidate scorer of the beam path, final softcap included: the
    ``gather_scores`` kernel on the card (its plain version on the CPU).
    The reference's vocab-sharded scorer (``mesh=``) waits for ROADMAP
    item 12."""
    if cfg.final_logit_softcap:
        return _softcap_score_fn(cfg.final_logit_softcap, heads_lib.kernel_scores)
    return heads_lib.kernel_scores


def masked_full_logits(cfg: ModelConfig, params: HeadParams, h: torch.Tensor
                       ) -> torch.Tensor:
    """(…, V_pad) logits with padded rows masked and final softcap applied."""
    logits = heads_lib.full_logits(params, h)
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    return torch.where(pad_mask, logits, -1e30)


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
                         state: LMHeadState, h: torch.Tensor) -> torch.Tensor:
    """Full-vocab scores with Eq. 5 bias removal (adversarial head)."""
    scores = masked_full_logits(cfg, params, h)
    if not hcfg.debias:
        return scores
    pad = cfg.padded_vocab - cfg.vocab_size
    if hcfg.kind == "adversarial_ns" and state.gen.tree is not None:
        log_pn = tree_lib.log_prob_all(state.gen.tree, gen_features(state, h))
        return scores + torch.nn.functional.pad(log_pn, (0, pad))
    if hcfg.kind == "freq_ns":
        return scores + torch.nn.functional.pad(state.gen.freq_log, (0, pad))
    return scores
