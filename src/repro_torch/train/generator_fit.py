"""Fitting the adversarial generator for an LM, as
``repro.train.generator_fit``.

The paper fits the tree on fixed input features. An LM's features evolve, so
the generator is fitted on a frozen snapshot: run the current model over a
few batches, collect (hidden state, next token) pairs, PCA-project the
hiddens to k dims (paper §3 "Technical Details") and fit the tree. The
resulting (proj, tree) pair replaces ``LMHeadState``; the discriminator trains
against it until the next refresh.

Fitting goes through :mod:`repro_torch.genfit` (level-parallel by default,
its sums in the ``segment_stats`` kernel on the card; the sequential
recursion and the subtree-sharded fitter as options), and
:func:`refresh_lm_generator` is the warm-start path of mid-training
refreshes: the projection is kept and only node parameters are re-solved,
optionally with drift-triggered subtree refits. Every path is a
deterministic function of (params, state, batches, config), which the
asynchronous refresh relies on.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import heads as heads_lib
from repro_torch.core import samplers as samplers_lib
from repro_torch.core.heads import Generator
from repro_torch.core.tree_fit import FitConfig, fit_tree, pca_projection
from repro_torch.genfit import fit_tree_levelwise, fit_tree_sharded, refresh_tree
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm_head import LMHeadState

_FITTERS = {
    "levelwise": fit_tree_levelwise,
    "sequential": fit_tree,
    "sharded": fit_tree_sharded,
}


def _device(params) -> torch.device:
    return params["head"]["w"].device


def collect_features(params, cfg: ModelConfig, batches: Iterable[dict],
                     max_tokens: int = 200_000) -> Tuple[np.ndarray, np.ndarray]:
    """Run the model; return (hiddens (N, d) float32, labels (N,)) as numpy,
    N <= ``max_tokens``.

    Each batch runs at its own shape (nothing is traced, so a ragged final
    batch needs no padding, and its rows are those of its own forward).
    Collection stops requesting batches once the cap is reached, and a
    batch is truncated to the remaining budget. The forward is the training
    path's (plain attention), without gradients.
    """
    dev = _device(params)
    hs, ys = [], []
    remaining = int(max_tokens)
    for batch in batches:
        tok = torch.as_tensor(batch["tokens"], device=dev)
        lab = torch.as_tensor(batch["labels"]).cpu().numpy()
        with torch.no_grad():
            h, _, _ = transformer.forward(params, cfg, tok, attn_impl="plain")
        h = h.float().reshape(-1, cfg.d_model)
        y = lab.reshape(-1)
        take = min(len(y), remaining)
        hs.append(h[:take].cpu().numpy())
        ys.append(y[:take])
        remaining -= take
        if remaining <= 0:
            break
    if not hs:
        raise ValueError("collect_features: no batches")
    return np.concatenate(hs), np.concatenate(ys)


def _fit_projected_tree(feats, labels, cfg: ModelConfig,
                        fit_config: Optional[FitConfig], method: str, dev):
    """PCA-project, fit, fold the centering into the node biases."""
    proj_np, mean = pca_projection(feats, cfg.gen_feature_dim)
    x_gen = (feats - mean) @ proj_np
    tree = _FITTERS[method](x_gen, labels, cfg.vocab_size,
                            config=fit_config or FitConfig(reg=0.1), device=dev)
    # The tree was fitted on centered features (h - mean) @ proj, but at
    # train time x_gen = h @ proj. Fold the centering into the node biases:
    # w.((h - mean) @ proj) + b = w.(h @ proj) + (b - w.(mean @ proj)).
    # Padding-forcing nodes have w = 0, so their biases are untouched.
    offset = torch.from_numpy(np.asarray(-(mean @ proj_np), np.float32)).to(dev)
    shifted = tree._replace(b=tree.b + tree.w @ offset)
    return shifted, torch.from_numpy(proj_np).to(dev)


def fit_lm_generator(params, cfg: ModelConfig, batches: Iterable[dict],
                     kind: str = "adversarial_ns",
                     fit_config: Optional[FitConfig] = None,
                     max_tokens: int = 200_000,
                     method: str = "levelwise") -> LMHeadState:
    """Snapshot-fit the generator; returns a fresh LMHeadState on the params'
    device. ``method`` selects the fitter: ``levelwise`` (default; O(log C)
    sequential phases), ``sequential`` (the reference recursion) or
    ``sharded`` (subtree fan-out)."""
    dev = _device(params)
    feats, labels = collect_features(params, cfg, batches, max_tokens)
    if kind == "freq_ns":
        counts = np.bincount(labels, minlength=cfg.vocab_size).astype(np.float32)
        gen = heads_lib.make_freq_generator(counts, device=dev)
        proj = torch.zeros((cfg.d_model, cfg.gen_feature_dim), dtype=torch.float32,
                           device=dev)
        return LMHeadState(gen=gen, proj=proj)
    tree, proj = _fit_projected_tree(feats, labels, cfg, fit_config, method, dev)
    return LMHeadState(gen=Generator(tree=tree), proj=proj)


def refresh_lm_generator(prev: LMHeadState, params, cfg: ModelConfig,
                         batches: Iterable[dict],
                         fit_config: Optional[FitConfig] = None,
                         max_tokens: int = 200_000,
                         prev_counts: Optional[np.ndarray] = None,
                         drift_threshold: Optional[float] = None
                         ) -> Tuple[LMHeadState, np.ndarray]:
    """Warm-start generator refresh: keeps ``prev.proj`` (the feature space
    stays fixed, so the previous tree's split assignments stay meaningful)
    and re-solves only node parameters from a fresh snapshot, plus
    drift-triggered subtree refits when ``drift_threshold`` and
    ``prev_counts`` are given. Returns ``(head_state, label_counts)``."""
    if prev.gen.tree is None:
        raise ValueError("refresh_lm_generator: no tree to warm-start from")
    dev = _device(params)
    feats, labels = collect_features(params, cfg, batches, max_tokens)
    x_gen = feats @ prev.proj.cpu().numpy().astype(np.float32)
    tree, counts = refresh_tree(prev.gen.tree, x_gen, labels, cfg.vocab_size,
                                config=fit_config or FitConfig(reg=0.1),
                                prev_counts=prev_counts,
                                drift_threshold=drift_threshold, device=dev)
    return LMHeadState(gen=Generator(tree=tree), proj=prev.proj), counts


def fit_lm_sampler(kind: str, params, cfg: ModelConfig, batches: Iterable[dict],
                   proj=None, max_tokens: int = 8_192, seed: int = 0, **kwargs):
    """Fit a :mod:`repro_torch.core.samplers` proposal from an LM snapshot:
    collect (hidden, next token) pairs, project the hiddens into the
    generator feature space (``proj``: pass ``head_state.proj`` so the
    sampler sees the x_gen the training step computes; a fresh PCA
    projection when None) and fit the sampler on per-class mean embeddings
    (lsh, rff) or label counts (unigram). Returns ``(sampler, proj)``."""
    dev = _device(params)

    def zeros_proj():
        return torch.zeros((cfg.d_model, cfg.gen_feature_dim), dtype=torch.float32,
                           device=dev)

    if kind == "uniform":
        return samplers_lib.UniformSampler(num_labels=cfg.vocab_size), (
            zeros_proj() if proj is None else proj)
    feats, labels = collect_features(params, cfg, batches, max_tokens)
    if kind == "unigram":
        counts = np.bincount(labels, minlength=cfg.vocab_size).astype(np.float32)
        return samplers_lib.unigram_from_counts(counts, device=dev), (
            zeros_proj() if proj is None else proj)
    if proj is None:
        proj_np, _ = pca_projection(feats, cfg.gen_feature_dim)
        proj = torch.from_numpy(proj_np).to(dev)
    # Uncentered, matching the train-time x_gen = h @ proj: no bias term to
    # fold a centering into (LSH codes are sign(x·plane)).
    x_gen = feats @ proj.cpu().numpy().astype(np.float32)
    sampler = samplers_lib.fit_sampler(kind, x_gen, labels, cfg.vocab_size, seed=seed,
                                       device=dev, **kwargs)
    return sampler, proj


def make_gen_fit_fn(cfg: ModelConfig, batch_fn, kind: str,
                    fit_config: Optional[FitConfig] = None,
                    max_tokens: int = 16_384, n_batches: int = 8,
                    batch_offset: int = 10_000, method: str = "levelwise",
                    warm_refresh: bool = True):
    """Build the ``gen_fit_fn(state) -> LMHeadState`` that ``run_loop``
    calls. The first fit (``state.gen_fit_step < 0``) is a full fit; later
    refreshes warm-start from the in-state tree when ``warm_refresh``. The
    choice reads only checkpointed state, so a resumed run replays the fit
    the uninterrupted run made."""

    def batches():
        return (batch_fn(batch_offset + i) for i in range(n_batches))

    def gen_fit(state):
        first = int(state.gen_fit_step) < 0
        if (first or not warm_refresh or kind != "adversarial_ns"
                or state.head_state.gen.tree is None):
            return fit_lm_generator(state.params, cfg, batches(), kind=kind,
                                    fit_config=fit_config, max_tokens=max_tokens,
                                    method=method)
        head, _ = refresh_lm_generator(state.head_state, state.params, cfg, batches(),
                                       fit_config=fit_config, max_tokens=max_tokens)
        return head

    return gen_fit
