"""Softmax heads, the prediction half: Eq. 5 bias removal, dense and
tree-beam top-k.

Heads score ``C`` labels from a feature ``h in R^K`` with an affine model
``xi_y(h) = w_y . h + b_y``. The *generator feature* ``x_gen in R^k`` fed to
the auxiliary tree is passed separately (paper: a PCA projection of the
input).

Head kinds (paper reference):
  softmax         — full softmax CE, Eq. 1 (appendix A.2 baseline)
  uniform_ns      — negative sampling, uniform noise, Eq. 2   (baseline i)
  freq_ns         — unconditional empirical-frequency noise   (baseline ii)
  adversarial_ns  — **the paper**: conditional tree noise, Eq. 6 objective,
                    Eq. 5 bias removal at prediction
  nce             — NCE with the tree as base distribution    (baseline iii)
  sampled_softmax — Bengio & Senecal sampled softmax w/ logQ correction
  ove             — One-vs-Each (Titsias 2016), stochastic    (baseline v)
  augment_reduce  — A&R softmax bound, stochastic reduce step (baseline iv)

The training losses are not ported yet. On the card, dense Eq. 5 scoring
runs the ``tree_logprob_all`` kernel and beam rescoring the
``gather_scores`` kernel; the logits product is ``torch.matmul`` in full
float32 (TF32 off, see :func:`repro_torch.device.resolve`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import device as device_lib
from repro_torch.core import samplers as samplers_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.samplers import NegativeSampler
from repro_torch.kernels import ops

SAMPLED_KINDS = ("uniform_ns", "freq_ns", "adversarial_ns", "nce",
                 "sampled_softmax", "ove", "augment_reduce")
HEAD_KINDS = ("softmax",) + SAMPLED_KINDS


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    num_labels: int
    kind: str = "adversarial_ns"
    n_neg: int = 1          # negatives per positive (paper uses 1)
    reg: float = 0.0        # lambda in Eq. 6
    debias: bool = True     # apply Eq. 5 at prediction time
    mask_accidental: bool = True  # sampled_softmax: mask negatives == target

    def __post_init__(self):
        if self.kind not in HEAD_KINDS:
            raise ValueError(f"unknown head kind {self.kind!r}; "
                             f"expected one of {HEAD_KINDS}")


class HeadParams(NamedTuple):
    """Trainable head parameters phi (Eq. 2)."""
    w: torch.Tensor   # (C, K)
    b: torch.Tensor   # (C,)


class Generator(NamedTuple):
    """Non-trainable noise-distribution state (the paper keeps the
    generator constant while training the discriminator)."""
    tree: Optional[tree_lib.Tree] = None
    freq_log: Optional[torch.Tensor] = None   # (C,) log empirical frequencies
    freq_cdf: Optional[torch.Tensor] = None   # (C,) inclusive CDF


def init_head_params(generator: torch.Generator, num_labels: int,
                     feature_dim: int, scale: float = 0.0,
                     dtype=torch.float32, device="cuda") -> HeadParams:
    """w ~ scale * N(0, 1) drawn on ``generator``'s device, b = 0."""
    dev = device_lib.resolve(device)
    w = scale * torch.randn((num_labels, feature_dim), generator=generator,
                            device=generator.device, dtype=torch.float32)
    return HeadParams(w=w.to(device=dev, dtype=dtype),
                      b=torch.zeros((num_labels,), dtype=dtype, device=dev))


def make_freq_generator(label_counts, device="cuda") -> Generator:
    """Generator for `freq_ns`: empirical label frequencies (§2.2), built by
    :func:`repro_torch.core.samplers.unigram_from_counts`."""
    s = samplers_lib.unigram_from_counts(label_counts, device=device)
    return Generator(freq_log=s.freq_log, freq_cdf=s.freq_cdf)


def make_tree_generator(tree: tree_lib.Tree) -> Generator:
    return Generator(tree=tree)


def candidate_scores(params: HeadParams, h: torch.Tensor, ids: torch.Tensor
                     ) -> torch.Tensor:
    """xi_{ids}(h) = w_{ids} . h + b_{ids}; ids: h.shape[:-1] + (n,).

    The plain O(K) gather-and-dot that replaces the O(K·C) logits matmul.
    """
    w = params.w[ids].float()                            # (..., n, K)
    return (torch.einsum("...nk,...k->...n", w, h.float())
            + params.b[ids].float())


def full_logits(params: HeadParams, h: torch.Tensor) -> torch.Tensor:
    """All-label scores, O(K·C): h @ W^T + b."""
    return h.float() @ params.w.float().T + params.b.float()


ScoreFn = Callable[[HeadParams, torch.Tensor, torch.Tensor], torch.Tensor]


def kernel_scores(params: HeadParams, h: torch.Tensor, ids: torch.Tensor
                  ) -> torch.Tensor:
    """:func:`candidate_scores` through ``ops.gather_scores`` (the CUDA
    kernel on the card). Batch dims are collapsed around the call; h and
    ids share them."""
    batch_shape, n = ids.shape[:-1], ids.shape[-1]
    flat = ops.gather_scores(params.w, params.b,
                             h.reshape(-1, h.shape[-1]).float().contiguous(),
                             ids.reshape(-1, n).contiguous())
    return flat.reshape(batch_shape + (n,))


def kernel_score_fn() -> ScoreFn:
    """Candidate scoring through the `gather_scores` kernel."""
    return kernel_scores


# ---------------------------------------------------------------------------
# Prediction (bias removal, Eq. 5).
# ---------------------------------------------------------------------------

def predictive_scores(cfg: HeadConfig, params: HeadParams, gen: Generator,
                      h: torch.Tensor, x_gen: torch.Tensor,
                      sampler: Optional[NegativeSampler] = None
                      ) -> torch.Tensor:
    """Unbiased predictive scores over all C labels.

    For `adversarial_ns` this is Theorem 1 / Eq. 5:
        xi_softmax = xi_ns + log p_n(y|x) + const,
    with log p_n over all leaves from the ``tree_logprob_all`` kernel,
    gathered to label order (:func:`tree_lib.log_prob_all`). For `freq_ns`
    the correction is the constant-per-label log-frequency. Uniform
    corrections are argmax-irrelevant. A head trained against an explicit
    ``sampler`` is debiased by *that* proposal's ``log_prob_all``.
    """
    scores = full_logits(params, h)
    if not cfg.debias:
        return scores
    if sampler is not None:
        return scores + sampler.log_prob_all(x_gen)
    if cfg.kind == "adversarial_ns" and gen.tree is not None:
        return scores + tree_lib.log_prob_all(gen.tree, x_gen)
    if cfg.kind == "freq_ns":
        return scores + gen.freq_log
    return scores


def rescore_candidates(cfg: HeadConfig, params: HeadParams, h: torch.Tensor,
                       cand: torch.Tensor, log_pn: torch.Tensor, topk: int,
                       score_fn: ScoreFn = kernel_scores
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score + Eq. 5 debias a proposed candidate set, keep the top ``topk``.

    ``cand`` entries < 0 are dead slots: they are scored as label 0 (the
    scorer never sees a negative id) and come back as label -1 with score
    -inf.
    """
    valid = cand >= 0
    xi = score_fn(params, h, cand.clamp(min=0))
    scores = xi + log_pn if cfg.debias else xi
    scores = torch.where(valid, scores, -torch.inf)
    top, sel = torch.topk(scores, topk, dim=-1)
    labels = torch.gather(cand, -1, sel)
    return top, labels


def predictive_topk(cfg: HeadConfig, params: HeadParams, gen: Generator,
                    h: torch.Tensor, x_gen: torch.Tensor, topk: int,
                    beam: Optional[int] = None,
                    score_fn: ScoreFn = kernel_scores,
                    sampler: Optional[NegativeSampler] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``topk`` unbiased predictive (scores, labels) without any O(C) pass.

    For `adversarial_ns`, beam search over the generator tree proposes
    ``beam`` candidates ranked by log p_n(y|x) in O(beam·k·log C); only
    those are scored (``score_fn``, by default the ``gather_scores``
    kernel) and Eq. 5 debiasing is applied on the candidate set: final
    score xi_y + log p_n(y|x). With ``beam >= C_pad`` the result equals the
    dense :func:`predictive_scores` top-k exactly.

    Other head kinds have no conditional candidate structure and fall back
    to dense scoring + top-k. Returns (scores, labels), each (..., topk);
    slots beyond the number of live candidates carry score -inf, label -1.
    With an explicit ``sampler``, the beam path runs iff the sampler is
    tree-backed (a :class:`~repro_torch.core.samplers.TreeSampler`).
    """
    if sampler is not None:
        tree = getattr(sampler, "tree", None)
    else:
        tree = gen.tree if cfg.kind == "adversarial_ns" else None
    if tree is None:
        scores = predictive_scores(cfg, params, gen, h, x_gen,
                                   sampler=sampler)
        top, labels = torch.topk(scores, topk, dim=-1)
        return top, labels
    if beam is None:
        beam = max(4 * topk, 16)
    beam = min(beam, tree_lib.padded_size(cfg.num_labels))
    cand, log_pn = tree_lib.beam_search(tree, x_gen, beam, beam)
    top, labels = rescore_candidates(cfg, params, h, cand, log_pn,
                                     min(topk, beam), score_fn=score_fn)
    if topk > beam:    # keep the documented (..., topk) output shape
        top = F.pad(top, (0, topk - beam), value=-torch.inf)
        labels = F.pad(labels, (0, topk - beam), value=-1)
    return top, labels


def predictive_log_likelihood(cfg, params, gen, h, x_gen, y,
                              mask: Optional[torch.Tensor] = None,
                              sampler: Optional[NegativeSampler] = None):
    """Mean test log-likelihood log softmax(scores)[y] (paper Fig. 1)."""
    scores = predictive_scores(cfg, params, gen, h, x_gen, sampler=sampler)
    logp = scores - torch.logsumexp(scores, dim=-1, keepdim=True)
    pos = torch.gather(logp, -1, y[..., None].long())[..., 0]
    if mask is None:
        return pos.mean()
    return (pos * mask).sum() / mask.sum().clamp(min=1.0)


def predictive_accuracy(cfg, params, gen, h, x_gen, y,
                        mask: Optional[torch.Tensor] = None,
                        sampler: Optional[NegativeSampler] = None):
    scores = predictive_scores(cfg, params, gen, h, x_gen, sampler=sampler)
    correct = (scores.argmax(dim=-1) == y).float()
    if mask is None:
        return correct.mean()
    return (correct * mask).sum() / mask.sum().clamp(min=1.0)
