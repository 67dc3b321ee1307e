"""Serving steps of the LM: prefill and the greedy decode step with the
paper's Eq. 5 bias removal, as ``repro.train.step``'s ``make_prefill`` and
``make_serve_step``. The training steps wait for ROADMAP item 10.
"""
from __future__ import annotations

from repro_torch.core.heads import HeadConfig, HeadParams
from repro_torch.models import lm_head, transformer
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig, hcfg: HeadConfig, topk_beam: int = 0):
    """Greedy decode step: one token in, one token out, cache updated in
    place.

    With ``topk_beam == 0`` (default) the predictive scores are dense: the
    paper's bias removal (Eq. 5) as an O(C·k) tree pass (the
    ``tree_logprob_all`` kernel on the card) riding on top of the O(C·K)
    logits matmul. With ``topk_beam > 0`` the decode never touches O(C):
    beam search over the generator tree proposes ``topk_beam`` candidates in
    O(beam·k·log C) and only those are scored (the ``gather_scores`` kernel
    on the card) and debiased. Both paths pick the same argmax whenever the
    true top-1 label survives the beam.
    """
    def serve_step(params, head_state, token, cache, cache_pos, positions=None):
        h, new_cache, _ = transformer.forward(
            params, cfg, token, positions=positions, cache=cache,
            cache_pos=cache_pos)
        head_params = HeadParams(**params["head"])
        if topk_beam:
            _, labels = lm_head.lm_predictive_topk(
                cfg, hcfg, head_params, head_state, h[:, -1], topk=1,
                beam=topk_beam)
            next_token = labels[..., 0]
        else:
            scores = lm_head.lm_predictive_scores(
                cfg, hcfg, head_params, head_state, h[:, -1])
            next_token = scores.argmax(dim=-1)
        return next_token[:, None], new_cache

    return serve_step


def make_prefill(cfg: ModelConfig):
    def prefill(params, tokens, cache, vision_embeds=None, positions=None):
        h, new_cache, _ = transformer.forward(
            params, cfg, tokens, positions=positions,
            vision_embeds=vision_embeds, cache=cache, cache_pos=0)
        return h, new_cache

    return prefill
