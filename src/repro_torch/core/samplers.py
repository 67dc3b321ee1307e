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
  uniform_shape(shape) -> the shape of the uniforms ``u`` of ``sample``
      (a data-parallel step draws the global batch's and keeps its rows).

Implementations:

  TreeSampler     — the paper's adversarial tree, O(k log C) per draw;
                    ``u`` holds one uniform per level, shape + (depth,).
  UniformSampler  — uniform over labels, O(1); ``u`` has ``shape``.
  UnigramSampler  — empirical label frequencies via inverse CDF, O(log C);
                    ``u`` has ``shape``. ``freq_log`` keeps 1e-12 smoothing
                    so debiasing an observed label stays finite;
                    ``freq_cdf`` is built from the unsmoothed counts, so a
                    count-0 label is never drawn.
  LshSampler      — signed-random-projection buckets over label embeddings
                    (Daghaghi et al., "A Tale of Two Efficient and
                    Informative Negative Sampling Distributions"): a draw
                    comes from the query's bucket, mixed with an eps-uniform
                    floor so log_prob is finite everywhere. ``u`` has
                    shape + (3,): [..., 0] picks the bucket (>= eps) or the
                    floor, [..., 1] the offset in the bucket, [..., 2] the
                    label of the floor.
  RffSampler      — positive random features of the softmax kernel (Rawat
                    et al., sampled softmax with kernel-based sampling):
                    p_n(y|x) ∝ φ(x)·φ(e_y), drawn exactly as a mixture over
                    the D feature components, with an eps-uniform floor.
                    ``u`` has shape + (4,): [..., 0] draws the component by
                    inverse CDF, [..., 1] the label from that component's
                    CDF, [..., 2] picks the kernel part (>= eps) or the
                    floor, [..., 3] the label of the floor.

A uniform ``v`` in [0, 1) picks label ``floor(v·C)`` wherever a sampler
draws a label uniformly. Conditional samplers built from a feature snapshot
(LSH/RFF) are static during training: unlike the tree they are not
refreshed by the generator fit.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Protocol, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.core import tree as tree_lib

SAMPLER_KINDS = ("tree", "uniform", "unigram", "lsh", "rff")


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


def _uniforms(generator: Optional[torch.Generator], u: Optional[torch.Tensor],
              shape: Tuple[int, ...], device) -> torch.Tensor:
    """``u`` on ``device``, or uniforms of ``shape`` drawn on the
    generator's device."""
    if u is None:
        if generator is None:
            raise ValueError("sample needs a generator or the uniforms u")
        u = torch.rand(shape, generator=generator, device=generator.device)
    return u.to(device)


def _uniform_labels(v: torch.Tensor, c: int) -> torch.Tensor:
    """Label floor(v·C) of uniforms v in [0, 1)."""
    return (v.double() * c).long().clamp(max=c - 1)


class TreeSampler(NamedTuple):
    """The paper's adversarial proposal: ancestral sampling down the
    balanced probabilistic tree, O(k log C) per draw (§3)."""
    tree: tree_lib.Tree

    def uniform_shape(self, shape):
        return tuple(shape) + (self.tree.depth,)

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

    def uniform_shape(self, shape):
        return tuple(shape)

    def sample(self, generator, x_gen, shape, u=None):
        shape = tuple(shape)
        c = self.num_labels
        if u is None:
            if generator is None:
                raise ValueError("sample needs a generator or the uniforms u")
            ids = torch.randint(0, c, shape, generator=generator,
                                device=generator.device).to(x_gen.device)
        else:
            ids = _uniform_labels(u.to(x_gen.device), c)
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

    def uniform_shape(self, shape):
        return tuple(shape)

    def sample(self, generator, x_gen, shape, u=None):
        u = _uniforms(generator, u, tuple(shape), self.freq_cdf.device)
        # right=True: a draw on a boundary belongs to the bucket above it,
        # and a count-0 label (an empty interval) is never drawn.
        ids = torch.searchsorted(self.freq_cdf, u.float(), right=True)
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


# ---------------------------------------------------------------------------
# LSH proposal (signed random projections over label embeddings).
# ---------------------------------------------------------------------------

class LshSampler(NamedTuple):
    """Bucket-uniform proposal from signed-random-projection LSH.

    Labels are hashed by the sign pattern of ``n_bits`` random projections
    of their embeddings; a query hashes its feature with the same planes and
    draws negatives uniformly from its own bucket: labels whose embeddings
    point the same way as the query, the hard negatives an informative
    proposal should favor. The proposal is the mixture

        p(y|x) = eps/C + (1-eps) * [ 1{code(y)=code(x)} / |bucket(x)|
                                      (or 1/C if the bucket is empty) ]

    so ``log_prob`` is finite for every label (Eq. 5 debiasing needs it: the
    positive label is usually outside the bucket). The per-draw log
    proposal probability is exact.
    """
    planes: torch.Tensor       # (k, n_bits) float32 random hyperplanes
    label_code: torch.Tensor   # (C,) int64 bucket code per label
    order: torch.Tensor        # (C,) int64 labels sorted by code
    starts: torch.Tensor       # (2**n_bits + 1,) int64 bucket offsets
    eps: torch.Tensor          # float32 scalar, the uniform-mixture weight

    @property
    def num_labels(self) -> int:
        return self.order.shape[0]

    def _code(self, x):
        """Bucket code of each query: bit i is ``x · planes[:, i] >= 0``."""
        bits = (x.float() @ self.planes >= 0).long()
        pow2 = 2 ** torch.arange(self.planes.shape[1], device=bits.device)
        return (bits * pow2).sum(dim=-1)

    def _bucket_prob(self, code, member):
        """(1-eps)-component probability of a label given the query code and
        whether the label is in the query's bucket."""
        size = (self.starts[code + 1] - self.starts[code]).float()
        return torch.where(size > 0, member.float() / size.clamp(min=1.0),
                           torch.full_like(size, 1.0 / self.num_labels))

    def _mixture(self, p_sel):
        c = float(self.num_labels)
        return torch.log(self.eps / c + (1.0 - self.eps) * p_sel)

    def log_prob(self, x_gen, y):
        code = self._code(_align(x_gen, y.shape))
        return self._mixture(self._bucket_prob(code, self.label_code[y] == code))

    def log_prob_all(self, x_gen):
        code = self._code(x_gen)[..., None]                     # (..., 1)
        return self._mixture(self._bucket_prob(code, self.label_code == code))

    def uniform_shape(self, shape):
        return tuple(shape) + (3,)

    def sample(self, generator, x_gen, shape, u=None):
        shape = tuple(shape)
        code = self._code(_align(x_gen, shape))
        u = _uniforms(generator, u, shape + (3,), code.device)
        start = self.starts[code]
        size = self.starts[code + 1] - start
        # The bucket with probability 1-eps (uniform where it is empty),
        # else the uniform floor.
        in_bucket = (u[..., 0] >= self.eps) & (size > 0)
        off = torch.minimum((u[..., 1] * size.float()).long(), (size - 1).clamp(min=0))
        bucket_ids = self.order[(start + off).clamp(max=self.num_labels - 1)]
        ids = torch.where(in_bucket, bucket_ids,
                          _uniform_labels(u[..., 2], self.num_labels))
        return ids, self.log_prob(x_gen, ids)


def fit_lsh_sampler(label_emb, n_bits: int = 8, eps: float = 0.05,
                    seed: int = 0, device="cuda") -> LshSampler:
    """Hash (C, k) label embeddings into 2**n_bits signed-projection buckets.
    The planes come from numpy's ``default_rng(seed)``, as in the JAX
    package; the hashing runs on ``device``."""
    dev = device_lib.resolve(device)
    emb = torch.as_tensor(label_emb).to(dev, torch.float32)
    c, k = emb.shape
    assert 1 <= n_bits <= 20, n_bits
    planes = np.random.default_rng(seed).standard_normal((k, n_bits)).astype(np.float32)
    planes = torch.from_numpy(planes).to(dev)
    codes = ((emb @ planes >= 0).long()
             * 2 ** torch.arange(n_bits, device=dev)).sum(dim=-1)
    order = torch.argsort(codes, stable=True)
    starts = torch.zeros(2 ** n_bits + 1, dtype=torch.int64, device=dev)
    starts[1:] = torch.cumsum(torch.bincount(codes, minlength=2 ** n_bits), 0)
    return LshSampler(planes=planes, label_code=codes, order=order, starts=starts,
                      eps=torch.tensor(eps, dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# RFF proposal (kernel-based sampled softmax).
# ---------------------------------------------------------------------------

class RffSampler(NamedTuple):
    """Positive random-feature approximation of the softmax proposal.

    With features φ(v) = exp(v·ω_d − |v|²/2) (Performer-style positive
    features; E_ω[φ(a)·φ(b)] = exp(a·b)), the kernel part of the proposal is

        p(y|x) ∝ Σ_d φ_d(x) z_{y,d},     z_{y,d} = φ_d(e_y),

    a D-component mixture: pick component d with probability
    ∝ φ_d(x)·Σ_y z_{y,d}, then draw y from that component's CDF. It is mixed
    with an eps/C uniform floor so log_prob is finite even where the feature
    map underflows. ``temperature`` T approximates softmax(x·e/T) by scaling
    both sides with 1/sqrt(T).

    Memory: ``log_z``/``comp_cdf`` are (C, D)/(D, C), comparable to one
    extra head embedding; ``sample`` gathers a (draws, C) block of CDF rows,
    222 MB for 256 draws at C = 217,240, so this proposal is for
    benchmark-scale C, not the 2M-label regime (the tree stays O(k log C)
    there).
    """
    omega: torch.Tensor        # (k, D) random directions
    log_z: torch.Tensor        # (C, D) log label features
    comp_logsum: torch.Tensor  # (D,) log Σ_y z_{y,d}
    comp_cdf: torch.Tensor     # (D, C) per-component inclusive CDF (ends 1.0)
    query_scale: torch.Tensor  # float32 scalar 1/sqrt(temperature)
    eps: torch.Tensor          # float32 scalar, the uniform-mixture weight

    @property
    def num_labels(self) -> int:
        return self.log_z.shape[0]

    def _log_phi(self, x):
        xs = x.float() * self.query_scale
        return xs @ self.omega - 0.5 * (xs * xs).sum(dim=-1, keepdim=True)

    def _features(self, x):
        """exp-domain query features shifted by the global label-feature max
        (the shift cancels between numerator and normalizer)."""
        lp = self._log_phi(x)
        e = torch.exp(lp - lp.amax(dim=-1, keepdim=True))         # (..., D)
        mz = self.log_z.max()
        den = e @ torch.exp(self.comp_logsum - mz)                 # (...,)
        return e, mz, den

    def _mixture_log_prob(self, num, den):
        c = float(self.num_labels)
        p_rff = torch.where(den > 0, num / den.clamp(min=1e-38),
                            torch.full_like(num, 1.0 / c))
        return torch.log(self.eps / c + (1.0 - self.eps) * p_rff)

    def log_prob(self, x_gen, y):
        e, mz, den = self._features(_align(x_gen, y.shape))
        num = (e * torch.exp(self.log_z[y] - mz)).sum(dim=-1)
        return self._mixture_log_prob(num, den)

    def log_prob_all(self, x_gen):
        e, mz, den = self._features(x_gen)
        num = e @ torch.exp(self.log_z - mz).T                     # (..., C)
        return self._mixture_log_prob(num, den[..., None])

    def uniform_shape(self, shape):
        return tuple(shape) + (4,)

    def sample(self, generator, x_gen, shape, u=None):
        shape = tuple(shape)
        lp = self._log_phi(_align(x_gen, shape))                   # shape + (D,)
        u = _uniforms(generator, u, shape + (4,), lp.device)
        # The component by inverse CDF over the D mixture weights.
        cdf = torch.cumsum(torch.softmax(lp + self.comp_logsum, dim=-1), dim=-1)
        cdf = cdf / cdf[..., -1:]
        d = torch.searchsorted(cdf, u[..., :1].contiguous(), right=True)
        d = d.clamp(max=cdf.shape[-1] - 1).reshape(-1)
        rows = self.comp_cdf[d]                                    # (draws, C)
        rff_ids = torch.searchsorted(rows, u[..., 1].reshape(-1, 1).contiguous(),
                                   right=True)
        rff_ids = rff_ids.reshape(shape).clamp(0, self.num_labels - 1)
        ids = torch.where(u[..., 2] >= self.eps, rff_ids,
                          _uniform_labels(u[..., 3], self.num_labels))
        return ids, self.log_prob(x_gen, ids)


def fit_rff_sampler(label_emb, n_features: int = 64, eps: float = 0.05,
                    temperature: float = 1.0, seed: int = 0,
                    device="cuda") -> RffSampler:
    """Build the RFF proposal from (C, k) label embeddings, in float64 on
    ``device`` so the per-component CDFs are well conditioned. The
    directions come from numpy's ``default_rng(seed)``, as in the JAX
    package."""
    dev = device_lib.resolve(device)
    emb = torch.as_tensor(label_emb).to(dev, torch.float64)
    c, k = emb.shape
    scale = 1.0 / math.sqrt(float(temperature))
    omega = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (k, n_features))).to(dev)
    emb_s = emb * scale
    log_z = emb_s @ omega - 0.5 * (emb_s ** 2).sum(dim=1, keepdim=True)
    mz = log_z.max()
    z = torch.exp(log_z - mz)                       # (C, D)
    comp_logsum = torch.log(z.sum(dim=0).clamp(min=1e-300)) + mz
    cdf = torch.cumsum(z, dim=0).T                  # (D, C)
    last = cdf[:, -1:]
    # Dividing each row by its own last entry makes it exactly 1.0, so
    # right=True sampling never falls off the end (see UnigramSampler).
    uniform = torch.arange(1, c + 1, dtype=torch.float64, device=dev)[None, :] / c
    cdf = torch.where(last > 0, cdf / last.clamp(min=1e-300), uniform)
    f32 = dict(dtype=torch.float32, device=dev)
    return RffSampler(omega=omega.to(**f32), log_z=log_z.to(**f32),
                      comp_logsum=comp_logsum.to(**f32),
                      comp_cdf=cdf.to(**f32).contiguous(),
                      query_scale=torch.tensor(scale, **f32),
                      eps=torch.tensor(eps, **f32))


# ---------------------------------------------------------------------------
# Construction helpers.
# ---------------------------------------------------------------------------

def class_mean_embeddings(x_gen, labels, num_labels: int, device="cuda") -> torch.Tensor:
    """(C, k) float64 label embeddings on ``device``: class means of the
    generator features (a label never observed gets the zero vector)."""
    dev = device_lib.resolve(device)
    x = torch.as_tensor(x_gen).to(dev, torch.float64)
    x = x.reshape(-1, x.shape[-1])
    y = torch.as_tensor(labels).to(dev, torch.int64).reshape(-1)
    sums = torch.zeros((num_labels, x.shape[-1]), dtype=torch.float64, device=dev)
    sums.index_add_(0, y, x)
    counts = torch.bincount(y, minlength=num_labels).to(torch.float64)
    return sums / counts.clamp(min=1.0)[:, None]


def fit_sampler(kind: str, x_gen, labels, num_labels: int, seed: int = 0,
                device="cuda", **kwargs) -> NegativeSampler:
    """Fit a sampler of the given kind from (features, labels) snapshots
    (arrays or tensors), on ``device``.

    ``tree`` runs the per-node generator fit
    (:func:`repro_torch.core.tree_fit.fit_tree`, sequential in C; at the
    paper's C wrap a :mod:`repro_torch.genfit` tree in a
    :class:`TreeSampler` instead); ``lsh``/``rff`` embed labels as class
    means of ``x_gen``; ``unigram`` needs only label counts; ``uniform``
    ignores the snapshot.
    """
    assert kind in SAMPLER_KINDS, kind
    if kind == "uniform":
        return UniformSampler(num_labels=num_labels)
    y = torch.as_tensor(labels).reshape(-1).to(torch.int64)
    if kind == "unigram":
        counts = torch.bincount(y, minlength=num_labels).float()
        return unigram_from_counts(counts, device=device)
    if kind == "tree":
        from repro_torch.core.tree_fit import FitConfig, fit_tree
        x = torch.as_tensor(x_gen).cpu().numpy().astype(np.float32)
        tree = fit_tree(x, y.cpu().numpy(), num_labels,
                        config=kwargs.pop("config", None) or FitConfig(reg=0.1, seed=seed),
                        device=device)
        return TreeSampler(tree=tree)
    emb = class_mean_embeddings(x_gen, y, num_labels, device=device)
    if kind == "lsh":
        return fit_lsh_sampler(emb, seed=seed, device=device, **kwargs)
    return fit_rff_sampler(emb, seed=seed, device=device, **kwargs)


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
