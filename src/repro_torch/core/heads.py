"""Softmax heads: the training losses, and prediction with Eq. 5 bias
removal, dense and tree-beam top-k.

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

Training: :func:`head_loss` is every kind's loss under ``torch.autograd``
(the dense path, and the only one for ``softmax``). The sparse path is split
at the candidates: :func:`_sample_candidates` draws them (slot 0 the
positive), and :func:`sparse_candidate_loss` computes the loss, the
:class:`~repro_torch.optim.sparse.SparseRows` head gradient and dL/dh from
closed-form coefficients through ``ops.sampled_head_loss`` — the CUDA kernel
on the card, its plain version on the CPU; :func:`sparse_head_loss` is the
two together. Prediction: on the card, dense Eq. 5 scoring runs the
``tree_logprob_all`` kernel and beam rescoring the ``gather_scores`` kernel;
the logits product is ``torch.matmul`` in full float32 (TF32 off, see
:func:`repro_torch.device.resolve`).
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
from repro_torch.kernels.sampled_loss import SAMPLED_KINDS, loss_and_coeffs
from repro_torch.optim.sparse import accumulate_rows

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


# ---------------------------------------------------------------------------
# Negative sampling + noise log-probs, per strategy.
# ---------------------------------------------------------------------------

def sample_negatives(cfg: HeadConfig, gen: Generator, x_gen: torch.Tensor,
                     generator: Optional[torch.Generator],
                     batch_shape: Tuple[int, ...],
                     sampler: Optional[NegativeSampler] = None,
                     u: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw (ids, log_pn) with shapes batch_shape + (n_neg,), from
    ``generator`` or the uniforms ``u`` (see
    :mod:`repro_torch.core.samplers`).

    With ``sampler=None``, ``cfg.kind`` picks the proposal: uniform for
    uniform_ns/ove/augment_reduce, the unigram inverse CDF for freq_ns, tree
    ancestral sampling (paper §3) for adversarial_ns/nce/sampled_softmax.
    """
    if sampler is None:
        sampler = samplers_lib.sampler_from_config(cfg, gen)
    return sampler.sample(generator, x_gen, tuple(batch_shape) + (cfg.n_neg,),
                          u=u)


def noise_log_prob(cfg: HeadConfig, gen: Generator, x_gen: torch.Tensor,
                   y: torch.Tensor,
                   sampler: Optional[NegativeSampler] = None) -> torch.Tensor:
    """log p_n(y|x) for given labels under the proposal distribution."""
    if sampler is None:
        sampler = samplers_lib.sampler_from_config(cfg, gen)
    return sampler.log_prob(x_gen, y)


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
# Losses.
# ---------------------------------------------------------------------------

def head_loss(cfg: HeadConfig, params: HeadParams, gen: Generator,
              h: torch.Tensor, x_gen: torch.Tensor, y: torch.Tensor,
              generator: Optional[torch.Generator],
              score_fn: ScoreFn = candidate_scores,
              mask: Optional[torch.Tensor] = None,
              sampler: Optional[NegativeSampler] = None,
              u: Optional[torch.Tensor] = None,
              denom: Optional[torch.Tensor] = None):
    """Per-strategy training loss, mean over batch. Returns (loss, metrics).

    h: (..., K); x_gen: (..., k); y: (...,) int labels; mask: (...,) in
    {0,1} — masked-out positions contribute 0. Differentiable in ``params``
    (and ``h``) under ``torch.autograd``: the dense path. ``sampler``
    overrides the proposal (default: the one ``cfg.kind`` implies, see
    :func:`sample_negatives`); negatives come from ``generator`` or ``u``.
    ``denom`` replaces the mask count as the mean's normaliser (a
    data-parallel rank passes the global batch's count).
    """
    if mask is None:
        mask = torch.ones(y.shape, dtype=torch.float32, device=h.device)
    if denom is None:
        denom = mask.sum().clamp(min=1.0)

    def mean(v):
        return (v * mask).sum() / denom

    if cfg.kind == "softmax":
        logits = full_logits(params, h)
        logz = torch.logsumexp(logits, dim=-1)
        pos = torch.gather(logits, -1, y[..., None].long())[..., 0]
        loss = mean(logz - pos)
        if cfg.reg:  # score regularizer (cf. Eq. 6 with log p_n absorbed)
            loss = loss + cfg.reg * mean(torch.square(logits).mean(dim=-1))
        return loss, {"pos_score": mean(pos.detach())}

    # Sampled strategies share one candidate layout (slot 0 = positive) and
    # one objective definition, `kernels.sampled_loss.loss_and_coeffs`, used
    # here under autograd and by the sparse path for its coefficients.
    ids, slot_logp, acc_hit = _sample_candidates(cfg, gen, x_gen, y, generator,
                                                 sampler=sampler, u=u)
    scores = score_fn(params, h, ids)                  # (..., 1 + n_neg)
    loss_vec, _, xi = loss_and_coeffs(
        scores, slot_logp, acc_hit, kind=cfg.kind,
        num_labels=cfg.num_labels, reg=cfg.reg, softcap=0.0,
        mask_accidental=cfg.mask_accidental)
    return mean(loss_vec), _sampled_metrics(cfg, xi.detach(), mean)


def _sample_candidates(cfg: HeadConfig, gen: Generator, x_gen: torch.Tensor,
                       y: torch.Tensor, generator: Optional[torch.Generator],
                       sampler: Optional[NegativeSampler] = None,
                       u: Optional[torch.Tensor] = None):
    """Candidate slots for a sampled strategy: int64 ids (..., 1+n) with the
    positive in slot 0, noise log-probs per slot (zeros where the strategy
    ignores them), and the accidental-hit mask. No gradient flows through
    them."""
    with torch.no_grad():
        y = y.long()
        neg_ids, neg_logp = sample_negatives(cfg, gen, x_gen, generator,
                                             y.shape, sampler=sampler, u=u)
        need_pos_logp = (cfg.kind in ("nce", "sampled_softmax")
                         or (cfg.reg and cfg.kind in ("uniform_ns", "freq_ns",
                                                      "adversarial_ns")))
        pos_logp = (noise_log_prob(cfg, gen, x_gen, y, sampler=sampler)
                    if need_pos_logp else
                    torch.zeros(y.shape, dtype=torch.float32, device=y.device))
        ids = torch.cat([y[..., None], neg_ids], dim=-1)
        slot_logp = torch.cat([pos_logp[..., None].float(), neg_logp.float()],
                              dim=-1)
        acc_hit = torch.cat([torch.zeros(y.shape + (1,), dtype=torch.bool,
                                         device=y.device),
                             neg_ids == y[..., None]], dim=-1)
    return ids, slot_logp, acc_hit


def resolve_head_update(head_update: str, kind: str) -> str:
    """'auto' → sparse for sampled heads, dense for the softmax baseline.
    The single definition of the head-update policy."""
    if head_update == "auto":
        return "dense" if kind == "softmax" else "sparse"
    if head_update not in ("dense", "sparse"):
        raise ValueError(f"head_update must be auto, dense or sparse, "
                         f"got {head_update!r}")
    if head_update == "sparse" and kind == "softmax":
        raise ValueError("softmax has no sampled candidate set")
    return head_update


def _sampled_metrics(cfg: HeadConfig, xi: torch.Tensor, mean) -> dict:
    metrics = {"pos_score": mean(xi[..., 0])}
    if cfg.kind in ("uniform_ns", "freq_ns", "adversarial_ns", "nce"):
        metrics["neg_score"] = mean(xi[..., 1:].mean(dim=-1))
    # Online proxy of the signal mass (Eq. A8/15): at the nonparametric
    # optimum E_{y~p_D}[σ(-ξ)] and E_{y~p_n}[σ(ξ)] both equal it, and it
    # reaches its bound 1/2 exactly when p_n = p_D (Theorem 2).
    metrics["snr_proxy"] = 0.5 * (
        mean(torch.sigmoid(-xi[..., 0]))
        + mean(torch.sigmoid(xi[..., 1:]).mean(dim=-1)))
    return metrics


def sparse_candidate_loss(cfg: HeadConfig, params: HeadParams, h: torch.Tensor,
                          ids: torch.Tensor, slot_logp: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          softcap: float = 0.0,
                          denom: Optional[torch.Tensor] = None):
    """The sampled loss of given candidates with O(B·K·n_neg) analytic
    gradients — no (C, K) buffer anywhere.

    ids: (..., m) int64 with the positive in slot 0; slot_logp: (..., m);
    h: (..., K); mask: (...,) in {0, 1}. The gather, scores, per-kind loss,
    score coefficients and ``dh`` come from ``ops.sampled_head_loss`` (the
    CUDA kernel on the card); the head gradient is the per-unique-row sums
    of the rank-1 terms ``coeff · h`` (``optim.sparse.accumulate_rows``).
    ``softcap`` applies the final-logit softcap, its chain rule folded into
    the coefficients. ``denom`` replaces the mask count as the loss's
    normaliser (a data-parallel rank passes the global batch's count).

    Returns ``(loss, metrics, SparseRows, dh)`` with dh = dL/dh (float32).
    """
    batch_shape, m = ids.shape[:-1], ids.shape[-1]
    kdim = h.shape[-1]
    if mask is None:
        mask = torch.ones(batch_shape, dtype=torch.float32, device=h.device)
    if denom is None:
        denom = mask.sum().clamp(min=1.0)
    h2 = h.reshape(-1, kdim).float().contiguous()
    ids2 = ids.reshape(-1, m).contiguous()
    loss_vec, coeff, xi, dh2 = ops.sampled_head_loss(
        params.w, params.b, h2, ids2, slot_logp.reshape(-1, m).float().contiguous(),
        kind=cfg.kind, num_labels=cfg.num_labels, reg=cfg.reg,
        softcap=softcap, mask_accidental=cfg.mask_accidental)

    wmask = (mask.reshape(-1) / denom).float()
    loss = (loss_vec * wmask).sum()
    coeff = coeff * wmask[:, None]

    def mean(v):
        return (v.reshape(batch_shape) * mask).sum() / denom

    metrics = _sampled_metrics(cfg, xi.reshape(batch_shape + (m,)), mean)
    grads = accumulate_rows(ids2.reshape(-1), coeff.reshape(-1),
                            h2[:, None, :].expand(-1, m, -1).reshape(-1, kdim),
                            num_rows=params.w.shape[0])
    dh = (dh2 * wmask[:, None]).reshape(h.shape)
    return loss, metrics, grads, dh


def sparse_head_loss(cfg: HeadConfig, params: HeadParams, gen: Generator,
                     h: torch.Tensor, x_gen: torch.Tensor, y: torch.Tensor,
                     generator: Optional[torch.Generator],
                     mask: Optional[torch.Tensor] = None,
                     softcap: float = 0.0,
                     sampler: Optional[NegativeSampler] = None,
                     u: Optional[torch.Tensor] = None):
    """Sampled-head loss with O(B·K·n_neg) analytic gradients: draws the
    candidates (:func:`_sample_candidates`, the same proposal and objective
    as :func:`head_loss`), then :func:`sparse_candidate_loss`. Returns
    ``(loss, metrics, SparseRows, dh)``; the ``SparseRows`` is a gradient
    ``optim.apply_updates`` takes for the whole head."""
    if cfg.kind == "softmax":
        raise ValueError("softmax has no sampled candidate set")
    ids, slot_logp, _ = _sample_candidates(cfg, gen, x_gen, y, generator,
                                           sampler=sampler, u=u)
    return sparse_candidate_loss(cfg, params, h, ids, slot_logp, mask=mask,
                                 softcap=softcap)


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
