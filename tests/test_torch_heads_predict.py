"""Prediction with Eq. 5 bias removal in the port (repro_torch.core.heads)
against the JAX package (repro.core.heads), on the CPU.

The same numpy head weights, tree and label counts go to both packages; the
JAX side uses its default ``candidate_scores`` scorer. Tolerance: 1e-4
absolute (tree log-probs summed over depth levels), 1e-5 relative. Inputs
are continuous and random, so top-k has no ties.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heads as jheads
from repro.core import samplers as jsamplers
from repro.core import tree as jtree
from repro_torch import convert
from repro_torch.core import heads as theads
from repro_torch.core import samplers as tsamplers
from repro_torch.core import tree as ttree

TOL = dict(atol=1e-4, rtol=1e-5)
C, KDIM, KG, B = 50, 16, 5, 12
KINDS = ["adversarial_ns", "freq_ns", "uniform_ns"]


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    w = (0.5 * rng.standard_normal((C, KDIM))).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    counts = rng.integers(0, 20, C).astype(np.float32)
    counts[[3, 17]] = 0.0
    jt = jtree.init_tree(jax.random.PRNGKey(1), C, KG, scale=0.8)
    h = rng.standard_normal((B, KDIM)).astype(np.float32)
    xg = rng.standard_normal((B, KG)).astype(np.float32)
    y = rng.integers(0, C, B)
    mask = (rng.random(B) < 0.7).astype(np.float32)
    jgen_freq = jheads.make_freq_generator(jnp.asarray(counts))
    jax_side = dict(
        params=jheads.HeadParams(jnp.asarray(w), jnp.asarray(b)),
        gens={"adversarial_ns": jheads.Generator(tree=jt),
              "freq_ns": jgen_freq, "uniform_ns": jheads.Generator()},
        samplers={"adversarial_ns": jsamplers.TreeSampler(jt),
                  "freq_ns": jsamplers.unigram_from_counts(jnp.asarray(counts)),
                  "uniform_ns": jsamplers.UniformSampler(C)},
        h=jnp.asarray(h), xg=jnp.asarray(xg), y=jnp.asarray(y, jnp.int32),
        mask=jnp.asarray(mask))
    tt = convert.tree_from_numpy(*(np.asarray(a) for a in jt), device="cpu")
    torch_side = dict(
        params=convert.head_params_from_numpy(w, b, device="cpu"),
        gens={"adversarial_ns": convert.generator_from_numpy(
                  tree=[np.asarray(a) for a in jt], device="cpu"),
              "freq_ns": convert.generator_from_numpy(
                  freq_log=np.asarray(jgen_freq.freq_log),
                  freq_cdf=np.asarray(jgen_freq.freq_cdf), device="cpu"),
              "uniform_ns": theads.Generator()},
        samplers={"adversarial_ns": tsamplers.TreeSampler(tt),
                  "freq_ns": tsamplers.unigram_from_counts(counts, device="cpu"),
                  "uniform_ns": tsamplers.UniformSampler(C)},
        h=torch.from_numpy(h), xg=torch.from_numpy(xg), y=torch.from_numpy(y),
        mask=torch.from_numpy(mask))
    return jax_side, torch_side


def _args(side, kind, debias, explicit):
    cfg_mod = jheads if isinstance(side["h"], jax.Array) else theads
    cfg = cfg_mod.HeadConfig(num_labels=C, kind=kind, debias=debias)
    sampler = side["samplers"][kind] if explicit else None
    return cfg, side["params"], side["gens"][kind], sampler


@pytest.mark.parametrize("explicit", [False, True], ids=["gen", "sampler"])
@pytest.mark.parametrize("debias", [True, False], ids=["debias", "raw"])
@pytest.mark.parametrize("kind", KINDS)
def test_predictive_scores_match_jax(problem, kind, debias, explicit):
    js, ts = problem
    cfg, p, g, s = _args(js, kind, debias, explicit)
    want = jax.jit(functools.partial(jheads.predictive_scores, cfg, sampler=s))(
        p, g, js["h"], js["xg"])
    cfg, p, g, s = _args(ts, kind, debias, explicit)
    got = theads.predictive_scores(cfg, p, g, ts["h"], ts["xg"], sampler=s)
    assert got.shape == (B, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("explicit", [False, True], ids=["gen", "sampler"])
@pytest.mark.parametrize("debias", [True, False], ids=["debias", "raw"])
@pytest.mark.parametrize("kind", KINDS)
def test_predictive_topk_matches_jax(problem, kind, debias, explicit):
    js, ts = problem
    cfg, p, g, s = _args(js, kind, debias, explicit)
    fn = jax.jit(functools.partial(jheads.predictive_topk, cfg, topk=3, beam=8,
                                   sampler=s))
    want_top, want_labels = fn(p, g, js["h"], js["xg"])
    cfg, p, g, s = _args(ts, kind, debias, explicit)
    top, labels = theads.predictive_topk(cfg, p, g, ts["h"], ts["xg"], 3,
                                         beam=8, sampler=s)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    np.testing.assert_allclose(top.numpy(), np.asarray(want_top), **TOL)


def test_topk_beyond_beam_pads_with_dead_slots(problem):
    js, ts = problem
    cfg, p, g, _ = _args(js, "adversarial_ns", True, False)
    fn = jax.jit(functools.partial(jheads.predictive_topk, cfg, topk=6, beam=4))
    want_top, want_labels = (np.asarray(a) for a in fn(p, g, js["h"], js["xg"]))
    cfg, p, g, _ = _args(ts, "adversarial_ns", True, False)
    top, labels = theads.predictive_topk(cfg, p, g, ts["h"], ts["xg"], 6, beam=4)
    assert top.shape == labels.shape == (B, 6)
    assert np.isneginf(top[:, 4:].numpy()).all() and (labels[:, 4:] == -1).all()
    assert np.isfinite(top[:, :4].numpy()).all() and (labels[:, :4] >= 0).all()
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    np.testing.assert_allclose(top.numpy(), want_top, **TOL)


@pytest.mark.parametrize("debias", [True, False], ids=["debias", "raw"])
def test_exhaustive_beam_equals_dense_topk(problem, debias):
    _, ts = problem
    cfg, p, g, _ = _args(ts, "adversarial_ns", debias, False)
    top, labels = theads.predictive_topk(cfg, p, g, ts["h"], ts["xg"], 5,
                                         beam=ttree.padded_size(C))
    dense = theads.predictive_scores(cfg, p, g, ts["h"], ts["xg"])
    want_top, want_labels = torch.topk(dense, 5, dim=-1)
    torch.testing.assert_close(labels, want_labels, rtol=0, atol=0)
    torch.testing.assert_close(top, want_top, **TOL)


def test_dead_candidates_score_minus_inf(problem):
    _, ts = problem
    cfg = theads.HeadConfig(num_labels=C)
    cand = torch.tensor([[4, -1, 7], [-1, -1, 2]])
    log_pn = torch.zeros(2, 3)
    top, labels = theads.rescore_candidates(cfg, ts["params"], ts["h"][:2],
                                            cand, log_pn, 3)
    assert (labels[0, :2] >= 0).all() and labels[0, 2] == -1
    assert labels[1, 0] == 2 and (labels[1, 1:] == -1).all()
    assert np.isneginf(top[1, 1:].numpy()).all()


@pytest.mark.parametrize("masked", [False, True], ids=["all", "mask"])
@pytest.mark.parametrize("kind", KINDS)
def test_accuracy_and_log_likelihood_match_jax(problem, kind, masked):
    js, ts = problem
    cfg, p, g, _ = _args(js, kind, True, False)
    jmask = js["mask"] if masked else None
    want_acc = jax.jit(functools.partial(jheads.predictive_accuracy, cfg))(
        p, g, js["h"], js["xg"], js["y"], mask=jmask)
    want_ll = jax.jit(functools.partial(jheads.predictive_log_likelihood, cfg))(
        p, g, js["h"], js["xg"], js["y"], mask=jmask)
    cfg, p, g, _ = _args(ts, kind, True, False)
    tmask = ts["mask"] if masked else None
    acc = theads.predictive_accuracy(cfg, p, g, ts["h"], ts["xg"], ts["y"], mask=tmask)
    ll = theads.predictive_log_likelihood(cfg, p, g, ts["h"], ts["xg"], ts["y"],
                                          mask=tmask)
    assert float(acc) == pytest.approx(float(want_acc), abs=1e-6)
    assert float(ll) == pytest.approx(float(want_ll), abs=1e-4)


def test_candidate_scores_and_kernel_scores_match_jax(problem):
    js, ts = problem
    ids = np.random.default_rng(3).integers(0, C, (B, 7))
    want = jax.jit(jheads.candidate_scores)(js["params"], js["h"],
                                            jnp.asarray(ids, jnp.int32))
    ids_t = torch.from_numpy(ids)
    got = theads.candidate_scores(ts["params"], ts["h"], ids_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    via_kernel = theads.kernel_score_fn()(ts["params"], ts["h"][:, None].expand(B, 2, KDIM),
                                         ids_t.reshape(B, 1, 7).expand(B, 2, 7))
    np.testing.assert_allclose(via_kernel[:, 1].numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_samplers_log_prob_match_jax(problem):
    js, ts = problem
    y = np.random.default_rng(4).integers(0, C, (B, 3))
    for kind in KINDS:
        want = jax.jit(js["samplers"][kind].log_prob)(js["xg"], jnp.asarray(y, jnp.int32))
        got = ts["samplers"][kind].log_prob(ts["xg"], torch.from_numpy(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ts["samplers"]["freq_ns"].freq_cdf.numpy(),
                               np.asarray(js["samplers"]["freq_ns"].freq_cdf),
                               atol=1e-6)


def test_sampler_from_config_picks_the_kind_proposal(problem):
    _, ts = problem
    gens = ts["gens"]
    for kind, cls in [("uniform_ns", tsamplers.UniformSampler),
                      ("ove", tsamplers.UniformSampler),
                      ("freq_ns", tsamplers.UnigramSampler),
                      ("adversarial_ns", tsamplers.TreeSampler),
                      ("nce", tsamplers.TreeSampler)]:
        gen = gens["freq_ns"] if kind == "freq_ns" else gens["adversarial_ns"]
        s = tsamplers.sampler_from_config(theads.HeadConfig(num_labels=C, kind=kind), gen)
        assert isinstance(s, cls)
    with pytest.raises(ValueError):
        tsamplers.sampler_from_config(theads.HeadConfig(num_labels=C, kind="softmax"),
                                      gens["adversarial_ns"])
    with pytest.raises(ValueError):
        theads.HeadConfig(num_labels=C, kind="no_such_head")
    assert theads.HEAD_KINDS == jheads.HEAD_KINDS


def test_init_head_params_shapes_and_dtype():
    p = theads.init_head_params(torch.Generator().manual_seed(0), 9, 4, scale=0.1,
                                dtype=torch.bfloat16, device="cpu")
    assert p.w.shape == (9, 4) and p.b.shape == (9,)
    assert p.w.dtype == p.b.dtype == torch.bfloat16
    assert (p.b == 0).all() and (p.w != 0).any()
