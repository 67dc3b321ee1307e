"""Negative-sampling proposals, the prediction half of ``NegativeSampler``.

Prediction needs a proposal's log-probabilities, for Eq. 5 debiasing:

  log_prob(x_gen, y) -> log p_n(y|x)
      Proposal log-probability of given labels.
  log_prob_all(x_gen) -> (..., C)
      Dense log p_n(·|x) for all labels — full-vocab Eq. 5 bias removal.

Implementations:

  TreeSampler     — the paper's adversarial tree, O(k log C) per label.
  UniformSampler  — uniform over labels.
  UnigramSampler  — empirical label frequencies. ``freq_log`` keeps 1e-12
                    smoothing so debiasing an observed label stays finite;
                    ``freq_cdf`` is built from the unsmoothed counts.

Drawing negatives (``sample``) belongs to training and is not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Protocol, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.core import tree as tree_lib


class NegativeSampler(Protocol):
    """Structural protocol — see the module docstring for the contract."""

    def log_prob(self, x_gen: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        ...

    def log_prob_all(self, x_gen: torch.Tensor) -> torch.Tensor:
        ...


def _align(x_gen: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Broadcast conditioning features to ``shape + (k,)``.

    ``x_gen`` arrives either already per-draw (ndim-1 == len(shape)) or
    per-batch-element (one fewer dim: the trailing n_neg axis is added).
    """
    shape = tuple(shape)
    if x_gen.dim() - 1 != len(shape):
        x_gen = x_gen[..., None, :]
    return x_gen.expand(shape + (x_gen.shape[-1],))


class TreeSampler(NamedTuple):
    """The paper's adversarial proposal: the balanced probabilistic tree
    (§3)."""
    tree: tree_lib.Tree

    def log_prob(self, x_gen, y):
        return tree_lib.log_prob(self.tree, _align(x_gen, y.shape), y)

    def log_prob_all(self, x_gen):
        return tree_lib.log_prob_all(self.tree, x_gen)


class UniformSampler(NamedTuple):
    """Uniform over the C real labels (baseline i)."""
    num_labels: int

    def log_prob(self, x_gen, y):
        return torch.full(y.shape, -math.log(self.num_labels),
                          dtype=torch.float32, device=y.device)

    def log_prob_all(self, x_gen):
        c = self.num_labels
        return torch.full(x_gen.shape[:-1] + (c,), -math.log(c),
                          dtype=torch.float32, device=x_gen.device)


class UnigramSampler(NamedTuple):
    """Empirical label frequencies (baseline ii).

    ``freq_cdf`` is the *unsmoothed* inclusive CDF normalized so the last
    entry is exactly 1.0 (count-0 labels own an empty interval);
    ``freq_log`` keeps the 1e-12 smoothing so debiasing an *observed* label
    (which may have count 0 under drift) stays finite.
    """
    freq_log: torch.Tensor   # (C,) smoothed log-frequencies (debiasing)
    freq_cdf: torch.Tensor   # (C,) unsmoothed inclusive CDF (sampling)

    def log_prob(self, x_gen, y):
        return self.freq_log[y]

    def log_prob_all(self, x_gen):
        return self.freq_log.expand(x_gen.shape[:-1] + self.freq_log.shape)


def unigram_from_counts(label_counts, device="cuda") -> UnigramSampler:
    """Build a UnigramSampler from raw label counts (array or tensor).

    The single definition of the frequency proposal — ``heads.
    make_freq_generator`` delegates here.
    """
    counts = torch.as_tensor(label_counts, dtype=torch.float32,
                             device=device_lib.resolve(device))
    smoothed = counts + 1e-12
    freq_log = torch.log(smoothed / smoothed.sum())
    cdf = torch.cumsum(counts, dim=0)
    # Dividing by the last entry makes it exactly 1.0 (x/x == 1 in IEEE).
    cdf = cdf / cdf[-1]
    return UnigramSampler(freq_log=freq_log, freq_cdf=cdf)


def sampler_from_config(cfg, gen) -> NegativeSampler:
    """The proposal a ``HeadConfig.kind`` implies. ``gen`` is the
    ``heads.Generator``."""
    if cfg.kind in ("uniform_ns", "ove", "augment_reduce"):
        return UniformSampler(num_labels=cfg.num_labels)
    if cfg.kind == "freq_ns":
        return UnigramSampler(freq_log=gen.freq_log, freq_cdf=gen.freq_cdf)
    if cfg.kind in ("adversarial_ns", "nce", "sampled_softmax"):
        return TreeSampler(tree=gen.tree)
    raise ValueError(f"{cfg.kind} draws no negatives")
