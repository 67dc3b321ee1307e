"""Negative-sampling proposals: the ``NegativeSampler`` protocol.

Every sampler implements three methods:

  sample(generator, x_gen, shape, u=None) -> (ids, log_pn)
      Draw proposal labels with the given shape (= batch_shape + (n_neg,));
      ``x_gen`` is the conditioning feature with shape batch_shape + (k,)
      (conditional samplers broadcast it over the trailing draw axis).
      The randomness comes from the ``torch.Generator`` (drawn on its own
      device, then moved to the sampler's), or from uniforms in [0, 1)
      passed as ``u``, so that a test can hand the JAX package and the port
      the same numbers. ``log_pn`` is the exact log proposal probability of
      each draw (Eq. 5 debiasing, the NCE / sampled-softmax corrections).
  log_prob(x_gen, y) -> log p_n(y|x)
      Proposal log-probability of given labels.
  log_prob_all(x_gen) -> (..., C)
      Dense log p_n(·|x) for all labels — full-vocab Eq. 5 bias removal.

Implementations:

  TreeSampler     — the paper's adversarial tree, O(k log C) per draw;
                    ``u`` holds one uniform per level, shape + (depth,).
  UniformSampler  — uniform over labels, O(1); ``u`` has ``shape``.
  UnigramSampler  — empirical label frequencies via inverse CDF, O(log C);
                    ``u`` has ``shape``. ``freq_log`` keeps 1e-12 smoothing
                    so debiasing an observed label stays finite;
                    ``freq_cdf`` is built from the unsmoothed counts, so a
                    count-0 label is never drawn.

The LSH and RFF proposals come with the head-math slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Protocol, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch.core import tree as tree_lib


class NegativeSampler(Protocol):
    """Structural protocol — see the module docstring for the contract."""

    def sample(self, generator: Optional[torch.Generator], x_gen: torch.Tensor,
               shape: Tuple[int, ...], u: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        ...

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
    """The paper's adversarial proposal: ancestral sampling down the
    balanced probabilistic tree, O(k log C) per draw (§3)."""
    tree: tree_lib.Tree

    def sample(self, generator, x_gen, shape, u=None):
        return tree_lib.sample(self.tree, _align(x_gen, shape),
                               generator=generator, u=u)

    def log_prob(self, x_gen, y):
        return tree_lib.log_prob(self.tree, _align(x_gen, y.shape), y)

    def log_prob_all(self, x_gen):
        return tree_lib.log_prob_all(self.tree, x_gen)


class UniformSampler(NamedTuple):
    """Uniform over the C real labels (baseline i)."""
    num_labels: int

    def sample(self, generator, x_gen, shape, u=None):
        shape = tuple(shape)
        c = self.num_labels
        if u is None:
            if generator is None:
                raise ValueError("sample needs a generator or the uniforms u")
            ids = torch.randint(0, c, shape, generator=generator,
                                device=generator.device).to(x_gen.device)
        else:
            ids = (u.to(x_gen.device).double() * c).long().clamp(max=c - 1)
        return ids, torch.full(shape, -math.log(c), dtype=torch.float32,
                               device=x_gen.device)

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

    def sample(self, generator, x_gen, shape, u=None):
        if u is None:
            if generator is None:
                raise ValueError("sample needs a generator or the uniforms u")
            u = torch.rand(tuple(shape), generator=generator,
                           device=generator.device)
        # right=True: a draw on a boundary belongs to the bucket above it,
        # and a count-0 label (an empty interval) is never drawn.
        ids = torch.searchsorted(self.freq_cdf,
                                 u.to(self.freq_cdf.device, torch.float32),
                                 right=True)
        ids = ids.clamp(0, self.freq_cdf.shape[0] - 1)
        return ids, self.freq_log[ids]

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
