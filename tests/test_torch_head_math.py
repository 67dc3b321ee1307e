"""The port's head math against the JAX package: the gradient SNR
(``repro.core.snr``), the five negative-sampling proposals
(``repro.core.samplers``), and the optimizer rules and compressed head state
(``repro.optim.optimizers``, ``repro.optim.compression``).

Each test names the reference test it mirrors or the reference function it
is held against. Inputs are made from a seed with numpy and given to both
packages; the JAX side runs under ``jax.jit``. Tolerances:
- SNR closed form: rtol 1e-5; Monte-Carlo estimates against the closed form
  rtol 0.05 (the reference's own);
- proposals: log-probs atol 1e-5, fitted float tables atol 1e-6. LSH codes
  are compared only where every |x·plane| exceeds 1e-5: a projection within
  float32 rounding of 0 may take either sign in two float32 products;
- one optimizer step from the same state: params rtol 1e-6 (atol 1e-7);
  fp32 state the same, bf16 state within one bf16 ulp and int8 payloads
  within one step of 127 (a float32 value one ulp away can round either
  way when it is stored);
- the reference's sparse == dense claims are held as properties of the
  port, torch against torch, at the reference's rtol 1e-5, atol 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.core import heads as jheads
from repro.core import samplers as jsamplers
from repro.core import snr as jsnr
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro.optim import sparse as jsparse
from repro_torch.core import heads as theads
from repro_torch.core import samplers as tsamplers
from repro_torch.core import snr as tsnr
from repro_torch.core import tree as ttree
from repro_torch.core import xc_train as txc
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizers as topt
from repro_torch.optim import sparse as tsparse

KINDS = tsamplers.SAMPLER_KINDS
assert KINDS == jsamplers.SAMPLER_KINDS


def _t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out.to(dtype) if dtype is not None else out


# ---------------------------------------------------------------------------
# Gradient SNR (tests/test_snr.py).
# ---------------------------------------------------------------------------

def _random_dist(seed, n, c, temp=1.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)) * temp
    p = np.exp(logits)
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed,n,c,temp", [(0, 4, 12, 1.2), (3, 8, 32, 2.0),
                                           (5, 5, 300, 0.5)])
def test_alpha_and_closed_form_match_jax(seed, n, c, temp):
    """``snr.alpha`` and ``snr.snr_closed_form`` against the JAX package's."""
    p_d, p_n = _random_dist(seed, n, c, temp), _random_dist(seed + 1, n, c, temp)
    want_a = jax.jit(jsnr.alpha)(jnp.asarray(p_d), jnp.asarray(p_n))
    want = jax.jit(jsnr.snr_closed_form)(jnp.asarray(p_d), jnp.asarray(p_n))
    np.testing.assert_allclose(tsnr.alpha(_t(p_d), _t(p_n)).numpy(), np.asarray(want_a),
                               rtol=1e-5)
    got = tsnr.snr_closed_form(_t(p_d), _t(p_n))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_empirical_matches_closed_form():
    """Mirror of test_snr.py::test_empirical_matches_closed_form."""
    p_d, p_n = _t(_random_dist(0, 4, 12, 1.2)), _t(_random_dist(1, 4, 12, 0.8))
    eta_cf = float(tsnr.snr_closed_form(p_d, p_n))
    eta_mc = float(tsnr.snr_empirical(p_d, p_n, torch.Generator().manual_seed(2),
                                      n_samples=400_000))
    assert eta_mc == pytest.approx(eta_cf, rel=0.05)


def test_adversarial_noise_maximizes_snr():
    """Mirror of test_snr.py::test_adversarial_noise_maximizes_snr."""
    n, c = 8, 32
    p_d = _t(_random_dist(3, n, c, temp=2.0))
    eta_adv = float(tsnr.snr_closed_form(p_d, p_d))
    uniform = torch.full((n, c), 1.0 / c)
    marginal = p_d.mean(0, keepdim=True).expand(n, c)
    assert eta_adv > float(tsnr.snr_closed_form(p_d, uniform))
    assert eta_adv > float(tsnr.snr_closed_form(p_d, marginal))
    for lam in (0.25, 0.5, 0.75):
        assert eta_adv >= float(tsnr.snr_closed_form(p_d, lam * p_d + (1 - lam) * uniform))


def test_snr_upper_bound_is_half_per_xy():
    """Mirror of test_snr.py::test_snr_upper_bound_is_half_per_xy."""
    n, c = 5, 16
    p_d = _t(_random_dist(4, n, c))
    eta = float(tsnr.snr_closed_form(p_d, p_d))
    assert eta == pytest.approx(1.0 / (n * n * (c - 1.0)), rel=1e-5)


def test_streamed_agrees_with_dense_reference():
    """Mirror of test_snr.py::test_streamed_agrees_with_dense_reference:
    ``snr_empirical`` and ``snr_empirical_dense`` within Monte-Carlo
    tolerance of the closed form and of each other."""
    p_d, p_n = _t(_random_dist(5, 4, 12, 1.2)), _t(_random_dist(6, 4, 12, 0.8))
    eta_cf = float(tsnr.snr_closed_form(p_d, p_n))
    eta_stream = float(tsnr.snr_empirical(p_d, p_n, torch.Generator().manual_seed(7),
                                          n_samples=400_000))
    eta_dense = float(tsnr.snr_empirical_dense(p_d, p_n, torch.Generator().manual_seed(7),
                                               n_samples=400_000))
    assert eta_stream == pytest.approx(eta_cf, rel=0.05)
    assert eta_dense == pytest.approx(eta_cf, rel=0.05)
    assert eta_stream == pytest.approx(eta_dense, rel=0.05)


def test_streamed_is_bitwise_deterministic():
    """Mirror of test_snr.py::test_streamed_is_bitwise_deterministic: the
    same generator state, n_samples and chunk give the same bits (a ragged
    last chunk included); another chunking stays within tolerance."""
    p_d, p_n = _t(_random_dist(8, 3, 10)), _t(_random_dist(9, 3, 10))

    def run(chunk):
        return tsnr.snr_empirical(p_d, p_n, torch.Generator().manual_seed(11),
                                  n_samples=50_001, chunk=chunk)

    a, b = run(256), run(256)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(run(128)) == pytest.approx(float(a), rel=0.05)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**20), n=st.integers(2, 6), c=st.integers(3, 40),
       temp=st.floats(0.2, 3.0))
def test_property_pd_is_global_max(seed, n, c, temp):
    """Mirror of test_snr.py::test_property_pd_is_global_max (Theorem 2)."""
    p_d = _t(_random_dist(seed, n, c, temp))
    p_other = _t(_random_dist(seed + 1, n, c, temp))
    assert (float(tsnr.snr_closed_form(p_d, p_d))
            >= float(tsnr.snr_closed_form(p_d, p_other)) - 1e-9)


# ---------------------------------------------------------------------------
# Proposals (tests/test_samplers.py, same problem).
# ---------------------------------------------------------------------------

C, KDIM, N_X = 24, 4, 6


def _sampler_problem(seed=0):
    """test_samplers.py's testbed: N_X contexts, a known p_D(.|x), and a
    fitting snapshot of (x_gen, y ~ p_D) pairs."""
    rng = np.random.default_rng(seed)
    ctx = rng.standard_normal((N_X, KDIM)).astype(np.float32)
    emb = rng.standard_normal((C, KDIM)).astype(np.float32)
    logits = 1.5 * ctx @ emb.T
    p_d = np.exp(logits - logits.max(-1, keepdims=True))
    p_d /= p_d.sum(-1, keepdims=True)
    xs = rng.integers(0, N_X, 4000)
    u = rng.random((4000, 1))
    ys = (p_d[xs].cumsum(-1) < u).sum(-1).clip(0, C - 1)
    return ctx, p_d.astype(np.float32), ctx[xs], ys.astype(np.int32)


@pytest.fixture(scope="module")
def fitted():
    ctx, p_d, x_fit, y_fit = _sampler_problem()
    jax_s = {k: jsamplers.fit_sampler(k, jnp.asarray(x_fit), jnp.asarray(y_fit), C, seed=0)
             for k in KINDS}
    port_s = {k: tsamplers.fit_sampler(k, x_fit, y_fit, C, seed=0, device="cpu")
              for k in KINDS}
    return ctx, p_d, x_fit, y_fit, jax_s, port_s


def _tie_free(x, planes, tol=1e-5):
    """Rows of x whose every projection on the planes exceeds tol."""
    return (np.abs(np.asarray(x, np.float64) @ np.asarray(planes, np.float64)) > tol).all(-1)


def test_class_mean_embeddings_match_jax(fitted):
    """``samplers.class_mean_embeddings`` against the JAX package's."""
    _, _, x_fit, y_fit, _, _ = fitted
    got = tsamplers.class_mean_embeddings(x_fit, y_fit, C, device="cpu")
    want = jsamplers.class_mean_embeddings(x_fit, y_fit, C)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_lsh_tables_match_jax(fitted):
    """``fit_lsh_sampler``'s tables against the JAX package's: the planes
    bit for bit, codes where no label projects within 1e-5 of a plane."""
    _, _, x_fit, y_fit, jax_s, port_s = fitted
    js, ts = jax_s["lsh"], port_s["lsh"]
    np.testing.assert_array_equal(ts.planes.numpy(), np.asarray(js.planes))
    emb = jsamplers.class_mean_embeddings(x_fit, y_fit, C).astype(np.float32)
    clear = _tie_free(emb, js.planes) | (np.abs(emb).sum(-1) == 0)
    assert clear.sum() >= C - 2, clear
    np.testing.assert_array_equal(ts.label_code.numpy()[clear],
                                  np.asarray(js.label_code)[clear])
    if clear.all():
        np.testing.assert_array_equal(ts.order.numpy(), np.asarray(js.order))
        np.testing.assert_array_equal(ts.starts.numpy(), np.asarray(js.starts))
    assert float(ts.eps) == float(js.eps)


def test_rff_tables_match_jax(fitted):
    """``fit_rff_sampler``'s float64 fit against the JAX package's numpy
    fit: every table at atol 1e-6."""
    _, _, _, _, jax_s, port_s = fitted
    js, ts = jax_s["rff"], port_s["rff"]
    for name in ("omega", "log_z", "comp_logsum", "comp_cdf", "query_scale", "eps"):
        got, want = getattr(ts, name), np.asarray(getattr(js, name))
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0, err_msg=name)
    assert float(ts.comp_cdf[:, -1].min()) == 1.0


def test_unigram_and_tree_tables_match_jax(fitted):
    """``fit_sampler('unigram')`` and ``fit_sampler('tree')`` against the
    JAX package's."""
    _, _, _, _, jax_s, port_s = fitted
    for name in ("freq_log", "freq_cdf"):
        np.testing.assert_allclose(getattr(port_s["unigram"], name).numpy(),
                                   np.asarray(getattr(jax_s["unigram"], name)), atol=1e-6)
    jt, tt = jax_s["tree"].tree, port_s["tree"].tree
    np.testing.assert_array_equal(tt.label_to_leaf.numpy(), np.asarray(jt.label_to_leaf))
    np.testing.assert_allclose(tt.w.numpy(), np.asarray(jt.w), atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_log_probs_match_jax(fitted, kind):
    """``log_prob_all`` and ``log_prob`` of each fitted kind against the JAX
    package's, at atol 1e-5 (LSH: on the contexts clear of every plane)."""
    ctx, _, _, _, jax_s, port_s = fitted
    rows = np.arange(N_X)
    if kind == "lsh":
        rows = rows[_tie_free(ctx, jax_s["lsh"].planes)]
        assert len(rows) >= N_X - 1
    y = (np.arange(N_X) * 5) % C
    want_all = jax.jit(jax_s[kind].log_prob_all)(jnp.asarray(ctx))
    want = jax.jit(jax_s[kind].log_prob)(jnp.asarray(ctx), jnp.asarray(y, jnp.int32))
    got_all = port_s[kind].log_prob_all(_t(ctx))
    got = port_s[kind].log_prob(_t(ctx), _t(y, torch.int64))
    np.testing.assert_allclose(got_all.numpy()[rows], np.asarray(want_all)[rows], atol=1e-5)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows], atol=1e-5)


def test_lsh_sample_with_jax_uniforms_matches_jax(fitted):
    """``LshSampler.sample`` fed the uniforms the JAX package's sampler
    draws (u[..., 2] the midpoint of its uniform label) gives its draws."""
    ctx, _, _, _, jax_s, port_s = fitted
    shape, key = (N_X, 64), jax.random.PRNGKey(3)
    want_ids, want_lp = jax.jit(jax_s["lsh"].sample, static_argnums=2)(
        key, jnp.asarray(ctx), shape)
    k_mix, k_off, k_uni = jax.random.split(key, 3)
    u = np.stack([np.asarray(jax.random.uniform(k_mix, shape)),
                  np.asarray(jax.random.uniform(k_off, shape)),
                  (np.asarray(jax.random.randint(k_uni, shape, 0, C)) + 0.5) / C], -1)
    rows = _tie_free(ctx, jax_s["lsh"].planes)
    ids, lp = port_s["lsh"].sample(None, _t(ctx), shape, u=_t(u.astype(np.float32)))
    np.testing.assert_array_equal(ids.numpy()[rows], np.asarray(want_ids)[rows])
    np.testing.assert_allclose(lp.numpy()[rows], np.asarray(want_lp)[rows], atol=1e-5)


def test_rff_sample_with_jax_uniforms_matches_jax(fitted):
    """``RffSampler.sample`` fed the JAX package's draws (its component as
    the midpoint of that component's interval of the port's mixture CDF)
    gives its labels."""
    ctx, _, _, _, jax_s, port_s = fitted
    js, ts = jax_s["rff"], port_s["rff"]
    shape, key = (N_X, 64), jax.random.PRNGKey(4)
    want_ids, want_lp = jax.jit(js.sample, static_argnums=2)(key, jnp.asarray(ctx), shape)
    k_d, k_u, k_mix, k_uni = jax.random.split(key, 4)
    x = jnp.broadcast_to(jnp.asarray(ctx)[:, None, :], shape + (KDIM,))
    d = np.asarray(jax.random.categorical(k_d, js._log_phi(x) + js.comp_logsum))
    lp = ts._log_phi(tsamplers._align(_t(ctx), shape)) + ts.comp_logsum
    cdf = torch.cumsum(torch.softmax(lp, -1), -1).numpy().astype(np.float64)
    cdf = np.concatenate([np.zeros(shape + (1,)), cdf / cdf[..., -1:]], -1)
    lo = np.take_along_axis(cdf, d[..., None], -1)[..., 0]
    hi = np.take_along_axis(cdf, d[..., None] + 1, -1)[..., 0]
    u = np.stack([(lo + hi) / 2, np.asarray(jax.random.uniform(k_u, shape)),
                  np.asarray(jax.random.uniform(k_mix, shape)),
                  (np.asarray(jax.random.randint(k_uni, shape, 0, C)) + 0.5) / C], -1)
    ids, got_lp = ts.sample(None, _t(ctx), shape, u=_t(u.astype(np.float32)))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_log_prob_all_normalizes(fitted, kind):
    """Mirror of TestProtocolProperties::test_log_prob_all_normalizes."""
    ctx, _, _, _, _, port_s = fitted
    lse = torch.logsumexp(port_s[kind].log_prob_all(_t(ctx)), -1)
    assert float(lse.abs().max()) < 1e-3, (kind, lse)


@pytest.mark.parametrize("kind", KINDS)
def test_log_prob_matches_log_prob_all(fitted, kind):
    """Mirror of TestProtocolProperties::test_log_prob_matches_log_prob_all."""
    ctx, _, _, _, _, port_s = fitted
    s = port_s[kind]
    y = torch.arange(N_X) % C
    dense = torch.gather(s.log_prob_all(_t(ctx)), -1, y[:, None])[:, 0]
    torch.testing.assert_close(s.log_prob(_t(ctx), y), dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_sample_reports_its_own_log_prob(fitted, kind):
    """Mirror of TestProtocolProperties::test_sample_reports_its_own_log_prob."""
    ctx, _, _, _, _, port_s = fitted
    s = port_s[kind]
    ids, lp = s.sample(torch.Generator().manual_seed(7), _t(ctx), (N_X, 5))
    torch.testing.assert_close(lp, s.log_prob(_t(ctx), ids), rtol=1e-5, atol=1e-5)
    assert int(ids.min()) >= 0 and int(ids.max()) < C


@pytest.mark.parametrize("kind", KINDS)
def test_sample_frequencies_match_log_prob(fitted, kind):
    """Mirror of TestProtocolProperties::test_sample_frequencies_match_log_prob:
    chi-square goodness of fit of 40,000 draws for one context against
    exp(log_prob_all), fixed seeds."""
    ctx, _, _, _, _, port_s = fitted
    i = KINDS.index(kind)
    s, n = port_s[kind], 40_000
    x = _t(ctx[i % N_X][None, :])
    p = torch.exp(s.log_prob_all(x))[0].double().numpy()
    p /= p.sum()
    ids = s.sample(torch.Generator().manual_seed(100 + i), x, (1, n))[0][0].numpy()
    obs = np.bincount(ids, minlength=C).astype(np.float64)
    exp = n * p
    keep = exp >= 5.0
    chi2 = float((((obs - exp) ** 2 / np.maximum(exp, 1e-12))[keep]).sum())
    assert obs[exp < 1e-6].sum() == 0, kind
    dof = int(keep.sum()) - 1
    assert chi2 < dof + 5.0 * np.sqrt(2.0 * dof), (kind, chi2, dof)


class TestUnigramCdfBugfix:
    """Mirror of test_samplers.py::TestUnigramCdfBugfix."""

    COUNTS = np.array([5, 0, 3, 0, 0, 2, 0, 0, 0, 0], np.float32)

    def test_zero_count_labels_never_sampled(self):
        s = tsamplers.unigram_from_counts(self.COUNTS, device="cpu")
        ids = s.sample(torch.Generator().manual_seed(0), torch.zeros((1, 2)), (1, 50_000))[0]
        assert set(ids.unique().tolist()) <= {0, 2, 5}

    def test_boundary_draws_map_to_positive_count_labels(self):
        s = tsamplers.unigram_from_counts(self.COUNTS, device="cpu")
        cdf = s.freq_cdf
        boundaries = cdf[:-1][cdf[:-1] < 1.0]
        ids = s.sample(None, None, tuple(boundaries.shape), u=boundaries)[0]
        assert (self.COUNTS[ids.numpy()] > 0).all(), ids

    def test_cdf_last_entry_exactly_one(self):
        s = tsamplers.unigram_from_counts(self.COUNTS, device="cpu")
        assert float(s.freq_cdf[-1]) == 1.0

    def test_heads_freq_generator_delegates(self):
        gen = theads.make_freq_generator(self.COUNTS, device="cpu")
        cfg = theads.HeadConfig(num_labels=len(self.COUNTS), kind="freq_ns", n_neg=4)
        ids, _ = theads.sample_negatives(cfg, gen, torch.zeros((2000, 2)),
                                         torch.Generator().manual_seed(3), (2000,))
        assert set(ids.unique().tolist()) <= {0, 2, 5}


def test_predictive_topk_invariant_to_sampler(fitted):
    """Mirror of TestEq5DebiasInvariance::test_predictive_topk_invariant_to_sampler:
    at the Eq. 5 optimum for each proposal the debiased top-3 is p_D's."""
    ctx, p_d, _, _, _, port_s = fitted
    h = torch.eye(N_X)
    cfg = theads.HeadConfig(num_labels=C, kind="adversarial_ns", n_neg=1)
    log_pd = torch.log(_t(p_d))
    want = np.sort(np.log(p_d), -1)[:, ::-1][:, :3]
    ref_labels = None
    for kind, s in port_s.items():
        w = (log_pd - s.log_prob_all(_t(ctx))).T.contiguous()
        params = theads.HeadParams(w=w, b=torch.zeros(C))
        top, labels = theads.predictive_topk(cfg, params, theads.Generator(), h, _t(ctx),
                                             topk=3, beam=64, sampler=s)
        np.testing.assert_allclose(top.numpy(), want, rtol=1e-4, atol=1e-4, err_msg=kind)
        if ref_labels is None:
            ref_labels = labels
        assert torch.equal(labels, ref_labels), kind


def test_predictive_accuracy_recovers_p_d_argmax(fitted):
    """Mirror of TestEq5DebiasInvariance::test_predictive_accuracy_recovers_p_d_argmax."""
    ctx, p_d, _, _, _, port_s = fitted
    cfg = theads.HeadConfig(num_labels=C, kind="adversarial_ns", n_neg=1)
    y_star = torch.argmax(_t(p_d), -1)
    for kind, s in port_s.items():
        w = (torch.log(_t(p_d)) - s.log_prob_all(_t(ctx))).T.contiguous()
        params = theads.HeadParams(w=w, b=torch.zeros(C))
        acc = theads.predictive_accuracy(cfg, params, theads.Generator(), torch.eye(N_X),
                                         _t(ctx), y_star, sampler=s)
        assert float(acc) == 1.0, kind


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("head_update", ("sparse", "dense"))
def test_sampler_matrix_trains(fitted, kind, head_update):
    """Mirror of TestSamplerMatrixTrains::test_trains_finite: each proposal
    drives 25 training steps (sparse and dense) to a finite log-likelihood
    above uniform's."""
    ctx, p_d, _, _, _, port_s = fitted
    rng = np.random.default_rng(5)
    xs = rng.integers(0, N_X, 1024)
    ys = (p_d[xs].cumsum(-1) < rng.random((1024, 1))).sum(-1).clip(0, C - 1)
    x = np.eye(N_X, dtype=np.float32)[xs]
    cfg = theads.HeadConfig(num_labels=C, kind="adversarial_ns", n_neg=2)
    params = txc.train_linear_head(cfg, theads.Generator(), x, ctx[xs], ys, lr=0.2,
                                   steps=25, batch_size=128, head_update=head_update,
                                   sampler=port_s[kind], device="cpu")
    ll = float(theads.predictive_log_likelihood(cfg, params, theads.Generator(), _t(x),
                                                _t(ctx[xs]), _t(ys), sampler=port_s[kind]))
    assert np.isfinite(ll) and ll > -np.log(C), (kind, head_update, ll)


# ---------------------------------------------------------------------------
# Head state (the single-device part of tests/test_state_memory.py).
# ---------------------------------------------------------------------------

SC, SK, SKG = 16, 12, 4


def _state_problem(batch=48, seed=0, c=SC):
    rng = np.random.default_rng(seed)
    h = _t(rng.standard_normal((batch, SK)).astype(np.float32))
    xg = _t(rng.standard_normal((batch, SKG)).astype(np.float32))
    y = _t(rng.integers(0, c, batch))
    w = _t((0.3 * rng.standard_normal((c, SK))).astype(np.float32))
    gen = theads.make_tree_generator(ttree.init_tree(torch.Generator().manual_seed(seed), c,
                                                     SKG, scale=0.5, device="cpu"))
    return theads.HeadParams(w, torch.zeros(c)), h, xg, y, gen


def _clone(params):
    return theads.HeadParams(*(p.clone() for p in params))


def _dense_grads(cfg, params, gen, h, xg, y, seed):
    leaves = theads.HeadParams(*(p.detach().clone().requires_grad_() for p in params))
    loss, _ = theads.head_loss(cfg, leaves, gen, h, xg, y, torch.Generator().manual_seed(seed))
    return theads.HeadParams(*torch.autograd.grad(loss, leaves))


def _random_sparse(rng, c, k, touch_all=False):
    """A SparseRows gradient over a random unique subset of rows (or all of
    them) and its dense form. The port's rows carry no sentinel slot:
    ``accumulate_rows`` emits unique ids in [0, C) only."""
    ids = np.arange(c) if touch_all else rng.choice(c, size=int(rng.integers(1, c)),
                                                    replace=False)
    dw = rng.standard_normal((len(ids), k)).astype(np.float32)
    db = rng.standard_normal(len(ids)).astype(np.float32)
    dwd, dbd = np.zeros((c, k), np.float32), np.zeros(c, np.float32)
    dwd[ids], dbd[ids] = dw, db
    return (tsparse.SparseRows(_t(ids), _t(dw), _t(db)),
            theads.HeadParams(_t(dwd), _t(dbd)))


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16"])
def test_sm3_sparse_equals_dense_n_steps(state_dtype):
    """Mirror of TestSm3Parity::test_sparse_equals_dense_n_steps, torch
    against torch: 5 steps of sparse SM3 equal dense SM3, covers too."""
    cfg = theads.HeadConfig(num_labels=SC, kind="adversarial_ns", n_neg=2, reg=1e-3)
    params, h, xg, y, gen = _state_problem()
    ocfg = topt.OptimizerConfig(name="sm3", learning_rate=0.1, clip_norm=1.0,
                                state_dtype=state_dtype)
    pd, ps = _clone(params), _clone(params)
    sd, ss = topt.init_opt_state(ocfg, pd), topt.init_opt_state(ocfg, ps)
    for s in range(5):
        pd, sd, _ = topt.apply_updates(ocfg, pd, _dense_grads(cfg, pd, gen, h, xg, y, 11 + s), sd)
        _, _, rows, _ = theads.sparse_head_loss(cfg, ps, gen, h, xg, y,
                                                torch.Generator().manual_seed(11 + s))
        ps, ss, _ = topt.apply_updates(ocfg, ps, rows, ss)
    for a, b in zip(ps, pd):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert isinstance(ss.nu.w, topt.Sm3Cover) and isinstance(sd.nu.w, topt.Sm3Cover)
    torch.testing.assert_close(tcomp.load_rows(ss.nu.w.row), tcomp.load_rows(sd.nu.w.row),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ss.nu.w.col, sd.nu.w.col, rtol=1e-5, atol=1e-6)


def test_sm3_untouched_rows_are_bitwise_frozen():
    """Mirror of TestSm3Parity::test_untouched_rows_are_bitwise_frozen."""
    rng = np.random.default_rng(3)
    ocfg = topt.OptimizerConfig(name="sm3", learning_rate=0.1)
    params, _, _, _, _ = _state_problem(c=64)
    before = _clone(params)
    sp, _ = _random_sparse(rng, 64, SK)
    p2, _, _ = topt.apply_updates(ocfg, params, sp, topt.init_opt_state(ocfg, params))
    untouched = np.setdiff1d(np.arange(64), sp.ids.numpy())
    assert torch.equal(p2.w[untouched], before.w[untouched])
    assert torch.equal(p2.b[untouched], before.b[untouched])


def _trajectory(name, state_dtype, steps, lr, seed):
    cfg = theads.HeadConfig(num_labels=SC, kind="adversarial_ns", n_neg=2, reg=1e-3)
    params, h, xg, y, gen = _state_problem()
    ocfg = topt.OptimizerConfig(name=name, learning_rate=lr, state_dtype=state_dtype)
    opt = topt.init_opt_state(ocfg, params)
    losses = []
    for s in range(steps):
        loss, _, rows, _ = theads.sparse_head_loss(cfg, params, gen, h, xg, y,
                                                   torch.Generator().manual_seed(seed + s))
        losses.append(float(loss))
        params, opt, _ = topt.apply_updates(ocfg, params, rows, opt)
    return params, opt, losses


def test_bf16_storage_tracks_fp32():
    """Mirror of TestStateDtype::test_bf16_storage_tracks_fp32."""
    p32, _, l32 = _trajectory("sm3", "fp32", 12, 0.1, 21)
    p16, _, l16 = _trajectory("sm3", "bf16", 12, 0.1, 21)
    assert l32[-1] < l32[0] and l16[-1] < l16[0]
    assert abs(l16[-1] - l32[-1]) < 0.05, (l16[-1], l32[-1])
    torch.testing.assert_close(p16.w, p32.w, rtol=5e-2, atol=5e-3)


def test_int8_storage_runs_and_converges():
    """Mirror of TestStateDtype::test_int8_storage_runs_and_converges: int8
    mu (bf16 for the 1-D b), bf16 nu, through the sparse gather."""
    ocfg = topt.OptimizerConfig(name="adamw", learning_rate=0.05, state_dtype="int8")
    opt = topt.init_opt_state(ocfg, _state_problem()[0])
    assert isinstance(opt.mu.w, tcomp.QuantizedRows)
    assert opt.mu.b.dtype == torch.bfloat16
    assert opt.nu.w.dtype == torch.bfloat16 and opt.nu.b.dtype == torch.bfloat16
    params, _, losses = _trajectory("adamw", "int8", 15, 0.05, 31)
    assert bool(torch.isfinite(params.w).all())
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_store_load_rows_round_trip():
    """Mirror of TestStateDtype::test_store_load_rows_round_trip, and
    ``store_rows`` against the JAX package's: bf16 bit for bit; int8 scales
    within one float32 ulp (XLA's CPU compiler turns the division by the
    constant 127 into a product with its reciprocal, the port divides, as
    the reference's source reads), payloads equal except where x/scale lies
    within that rounding of a tie."""
    rng = np.random.default_rng(0)
    xn = rng.standard_normal((64, 7)).astype(np.float32)
    xn[3] = 0.0
    x = _t(xn)
    assert tcomp.store_rows(x, "fp32") is x
    b16 = tcomp.store_rows(x, "bf16")
    assert b16.dtype == torch.bfloat16
    np.testing.assert_array_equal(tcomp.load_rows(b16).numpy(),
                                  np.asarray(jnp.asarray(xn).astype(jnp.bfloat16)
                                             .astype(jnp.float32)))
    qr = tcomp.store_rows(x, "int8")
    jqr = jax.jit(jcomp.quantize_rows)(jnp.asarray(xn))
    assert qr.q.dtype == torch.int8 and qr.scale.shape == (64,)
    np.testing.assert_allclose(qr.scale.numpy(), np.asarray(jqr.scale), rtol=2.5e-7, atol=0)
    ratio = xn / qr.scale.numpy()[:, None]
    tie = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 2e-5
    same = qr.q.numpy() == np.asarray(jqr.q)
    assert (same | tie).all()
    err = (tcomp.dequantize_rows(qr) - x).abs()
    assert bool((err <= x.abs().amax(1, keepdim=True) / 127 + 1e-7).all())
    assert tcomp.store_rows(torch.ones(5), "int8").dtype == torch.bfloat16
    z = tcomp.quantize_rows(torch.zeros(3, 2))
    assert torch.equal(tcomp.dequantize_rows(z), torch.zeros(3, 2))
    assert torch.equal(z.scale, torch.ones(3))


@pytest.mark.parametrize("shape,fill,state_dtype", [
    ((6, 4), 0.0, "fp32"), ((6, 4), 0.1, "fp32"), ((6, 4), 0.0, "bf16"),
    ((6, 4), 0.1, "bf16"), ((6,), 0.0, "int8"), ((6,), 0.3, "int8"),
    ((6, 4), 0.0, "int8"), ((6, 4), -0.7, "int8")])
def test_full_rows_equals_store_rows_of_full(shape, fill, state_dtype):
    """``full_rows`` (the optimizer init's constant state, built without an
    fp32 table) equals ``store_rows`` of the fp32 constant bit for bit."""
    got = tcomp.full_rows(shape, fill, state_dtype, "cpu")
    want = tcomp.store_rows(torch.full(shape, fill), state_dtype)
    for g, w in zip(*(x if isinstance(x, tcomp.QuantizedRows) else (x,)
                      for x in (got, want))):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_error_feedback_compression_matches_jax():
    """``compress_with_error_feedback`` and ``decompress`` against the JAX
    package's over two rounds (the residual carried between them)."""
    rng = np.random.default_rng(1)
    grads = [{"w": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)} for _ in range(2)]
    jef = jcomp.init_ef_state({k: jnp.asarray(v) for k, v in grads[0].items()})
    tef = tcomp.init_ef_state({k: _t(v) for k, v in grads[0].items()})
    for g in grads:
        prev = {k: v.clone() for k, v in tef.error.items()}
        jq, js, jef = jax.jit(jcomp.compress_with_error_feedback)(
            {k: jnp.asarray(v) for k, v in g.items()}, jef)
        tq, ts, tef = tcomp.compress_with_error_feedback({k: _t(v) for k, v in g.items()}, tef)
        for k in g:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=2.5e-7, atol=0)
            assert (np.abs(tq[k].numpy().astype(int) - np.asarray(jq[k]).astype(int)) <= 1).all()
            np.testing.assert_allclose(tef.error[k].numpy(), np.asarray(jef.error[k]),
                                       atol=float(ts[k]) + 1e-7)
            # Nothing is lost: the payload plus the new residual is the
            # gradient plus the old residual.
            torch.testing.assert_close(tcomp.decompress(tq, ts)[k] + tef.error[k],
                                       _t(g[k]) + prev[k], rtol=0, atol=1e-6)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_lazy_adamw_random_touch_patterns_match_dense(seed):
    """Mirror of TestLazyAdamW::test_random_touch_patterns_match_dense,
    torch against torch: rows idle for random gaps replay their missed
    steps when next touched; a final all-rows touch makes sparse equal
    dense."""
    c, k, steps = 24, 6, 9
    rng = np.random.default_rng(seed)
    ocfg = topt.OptimizerConfig(name="adamw", learning_rate=0.03, weight_decay=0.2)
    params = theads.HeadParams(_t(rng.standard_normal((c, k)).astype(np.float32)),
                               _t(rng.standard_normal(c).astype(np.float32)))
    pd, ps = _clone(params), _clone(params)
    sd, ss = topt.init_opt_state(ocfg, pd), topt.init_opt_state(ocfg, ps)
    for s in range(steps):
        sp, gd = _random_sparse(rng, c, k, touch_all=(s == steps - 1))
        pd, sd, _ = topt.apply_updates(ocfg, pd, gd, sd)
        ps, ss, _ = topt.apply_updates(ocfg, ps, sp, ss)
    for a, b in zip(ps, pd):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_lazy_adamw_mixed_sparse_dense_steps_stay_exact():
    """Mirror of TestLazyAdamW::test_mixed_sparse_dense_steps_stay_exact:
    the dense branch also runs the catch-up and stamps ``last``."""
    c, k = 12, 5
    rng = np.random.default_rng(7)
    ocfg = topt.OptimizerConfig(name="adamw", learning_rate=0.05, weight_decay=0.1,
                                warmup_steps=3)
    params = theads.HeadParams(_t(rng.standard_normal((c, k)).astype(np.float32)),
                               torch.zeros(c))
    pd, ps = _clone(params), _clone(params)
    sd, ss = topt.init_opt_state(ocfg, pd), topt.init_opt_state(ocfg, ps)
    for s in range(6):
        sp, gd = _random_sparse(rng, c, k, touch_all=(s == 5))
        pd, sd, _ = topt.apply_updates(ocfg, pd, gd, sd)
        ps, ss, _ = topt.apply_updates(ocfg, ps, gd if s % 2 else sp, ss)
    torch.testing.assert_close(ps.w, pd.w, rtol=1e-5, atol=1e-6)


def _long_gap_params(rng, c, k):
    params = (rng.standard_normal((c, k)).astype(np.float32),
              rng.standard_normal(c).astype(np.float32))
    g0 = (rng.standard_normal((c, k)).astype(np.float32),
          rng.standard_normal(c).astype(np.float32))
    g1 = rng.standard_normal((1, k)).astype(np.float32)
    return params, g0, g1


def test_lazy_adamw_long_gap_uses_closed_form_tail():
    """Mirror of TestLazyAdamW::test_long_gap_uses_closed_form_tail: a
    399-step gap replays the first 197 missed steps (the auto horizon at
    beta1 = 0.9) and applies the closed-form tail for the other 202; it
    matches the full replay (horizon 1024) at rtol 1e-5, atol 1e-6."""
    c, k = 4, 3
    (w, b), (gw, gb), g1 = _long_gap_params(np.random.default_rng(1), c, k)
    outs = []
    for horizon in (1024, 0):
        ocfg = topt.OptimizerConfig(name="adamw", learning_rate=0.01, weight_decay=0.3,
                                    lazy_horizon=horizon)
        p = theads.HeadParams(_t(w), _t(b))
        p, o, _ = topt.apply_updates(ocfg, p, tsparse.SparseRows(torch.arange(c), _t(gw),
                                                                 _t(gb)),
                                     topt.init_opt_state(ocfg, p))
        o = o._replace(step=400)                        # rows idle for 399 steps
        p, o, _ = topt.apply_updates(ocfg, p, tsparse.SparseRows(
            torch.tensor([0]), _t(g1), torch.zeros(1)), o)
        assert topt._lazy_horizon(ocfg) == (horizon or 197)
        outs.append(p)
    torch.testing.assert_close(outs[1].w, outs[0].w, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(outs[1].b, outs[0].b, rtol=1e-5, atol=1e-6)


def test_lazy_adamw_long_gap_matches_jax():
    """The same 399-step gap (auto horizon and tail) against the JAX
    package's ``apply_updates``, rows clear of the gap and the touched one
    both, at rtol 1e-5."""
    c, k = 4, 3
    (w, b), (gw, gb), g1 = _long_gap_params(np.random.default_rng(2), c, k)
    kw = dict(name="adamw", learning_rate=0.01, weight_decay=0.3)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jstep = jax.jit(functools.partial(jopt.apply_updates, jcfg))
    jp = jheads.HeadParams(jnp.asarray(w), jnp.asarray(b))
    jp, jo, _ = jstep(jp, jsparse.SparseRows(jnp.arange(c, dtype=jnp.int32),
                                             jnp.asarray(gw), jnp.asarray(gb)),
                      jopt.init_opt_state(jcfg, jp))
    jo = jo._replace(step=jnp.asarray(400, jnp.int32))
    one = jsparse.SparseRows(jnp.asarray([0, 1, 2, 3], jnp.int32),
                             jnp.asarray(np.concatenate([g1, np.zeros((3, k), np.float32)])),
                             jnp.zeros(4))
    # Rows 1-3 ride along with zero gradients: all four catch up 399 steps.
    jp, _, _ = jstep(jp, one, jo)
    tp = theads.HeadParams(_t(w), _t(b))
    tp, to, _ = topt.apply_updates(tcfg, tp, tsparse.SparseRows(torch.arange(c), _t(gw),
                                                                _t(gb)),
                                   topt.init_opt_state(tcfg, tp))
    tp, _, _ = topt.apply_updates(tcfg, tp, tsparse.SparseRows(
        torch.arange(4), _t(np.asarray(one.dw)), torch.zeros(4)), to._replace(step=400))
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# One step of each rule and state dtype against the JAX package.

def _leaf_to_torch(x):
    if x is None:
        return None
    if isinstance(x, jopt.Sm3Cover):
        return topt.Sm3Cover(_leaf_to_torch(x.row), _leaf_to_torch(x.col))
    if isinstance(x, jcomp.QuantizedRows):
        return tcomp.QuantizedRows(_leaf_to_torch(x.q), _leaf_to_torch(x.scale))
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return _t(a.astype(np.float32)).to(torch.bfloat16)
    return _t(a)


def _state_to_torch(js):
    def part(tree):
        return None if tree is None else theads.HeadParams(
            _leaf_to_torch(tree.w), _leaf_to_torch(tree.b))
    return topt.OptState(step=int(js.step), mu=part(js.mu), nu=part(js.nu),
                         last=part(js.last))


def _assert_leaf_close(got, want, what):
    if want is None:
        assert got is None, what
    elif isinstance(want, jopt.Sm3Cover):
        _assert_leaf_close(got.row, want.row, what + ".row")
        _assert_leaf_close(got.col, want.col, what + ".col")
    elif isinstance(want, jcomp.QuantizedRows):
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale), rtol=1e-6,
                                   err_msg=what)
        dq = np.abs(got.q.numpy().astype(int) - np.asarray(want.q).astype(int))
        assert dq.max() <= 1, what
    else:
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:
            assert got.dtype == torch.bfloat16, what
            np.testing.assert_allclose(got.float().numpy(), w.astype(np.float32),
                                       rtol=2.0 ** -7, atol=1e-30, err_msg=what)
        else:
            assert got.dtype == _t(w).dtype, what
            np.testing.assert_allclose(got.numpy(), w, rtol=1e-6, atol=1e-7, err_msg=what)


STEP_CASES = [(r, sd, f) for r in ("adagrad", "adamw", "sm3") for sd in ("fp32", "bf16", "int8")
              for f in ("sparse", "dense")] + [("sgd", "fp32", "sparse"), ("sgd", "fp32", "dense")]


@pytest.mark.parametrize("rule,state_dtype,grad_form", STEP_CASES)
def test_one_step_matches_jax(rule, state_dtype, grad_form):
    """One ``apply_updates`` step of each rule and state dtype, from a state
    the JAX package built over 3 sparse steps (AdamW rows idle for 0-2
    steps), against its ``apply_updates`` on the same state: params rtol
    1e-6, state at its storage's resolution."""
    c, k = 16, 5
    rng = np.random.default_rng(STEP_CASES.index((rule, state_dtype, "sparse")))
    kw = dict(name=rule, learning_rate=0.05, weight_decay=0.1, clip_norm=2.0,
              warmup_steps=2, decay_steps=10, state_dtype=state_dtype)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jstep = jax.jit(functools.partial(jopt.apply_updates, jcfg))
    jp = jheads.HeadParams(jnp.asarray(rng.standard_normal((c, k)), jnp.float32),
                           jnp.asarray(rng.standard_normal(c), jnp.float32))
    jo = jopt.init_opt_state(jcfg, jp)

    def grads():
        ids = np.sort(rng.choice(c, size=6, replace=False))
        dw = rng.standard_normal((6, k)).astype(np.float32)
        db = rng.standard_normal(6).astype(np.float32)
        return ids, dw, db

    for _ in range(3):
        ids, dw, db = grads()
        jp, jo, _ = jstep(jp, jsparse.SparseRows(jnp.asarray(ids, jnp.int32), jnp.asarray(dw),
                                                 jnp.asarray(db)), jo)
    tp = theads.HeadParams(*(_t(np.asarray(a)) for a in jp))
    to = _state_to_torch(jo)
    ids, dw, db = grads()
    if grad_form == "sparse":
        jg = jsparse.SparseRows(jnp.asarray(ids, jnp.int32), jnp.asarray(dw), jnp.asarray(db))
        tg = tsparse.SparseRows(_t(ids), _t(dw), _t(db))
    else:
        gw, gb = np.zeros((c, k), np.float32), np.zeros(c, np.float32)
        gw[ids], gb[ids] = dw, db
        jg = jheads.HeadParams(jnp.asarray(gw), jnp.asarray(gb))
        tg = theads.HeadParams(_t(gw), _t(gb))
    want_p, want_o, want_m = jstep(jp, jg, jo)
    got_p, got_o, got_m = topt.apply_updates(tcfg, tp, tg, to)
    assert got_o.step == int(want_o.step) == 4
    assert got_m["lr"] == pytest.approx(float(want_m["lr"]), rel=1e-6)
    for got, want in zip(got_p, want_p):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for part in ("mu", "nu", "last"):
        want_part = getattr(want_o, part)
        if want_part is None:
            assert getattr(got_o, part) is None, part
            continue
        for name, got, want in zip(("w", "b"), getattr(got_o, part), want_part):
            _assert_leaf_close(got, want, f"{part}.{name}")


def test_global_norm_over_state_boxes_matches_jax():
    """Mirror of TestGlobalNormStateLeaves::test_fp32_norm_over_boxes,
    against the JAX package's ``global_norm``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    jtree = {"a": jcomp.quantize_rows(jnp.asarray(x)),
             "b": jopt.Sm3Cover(row=jnp.asarray([1.0, 2.0], jnp.bfloat16),
                                col=jnp.asarray([3.0], jnp.float32)),
             "c": jnp.full((2, 2), 0.5, jnp.bfloat16)}
    ttree_ = {"a": tcomp.quantize_rows(_t(x)),
              "b": topt.Sm3Cover(row=torch.tensor([1.0, 2.0], dtype=torch.bfloat16),
                                 col=torch.tensor([3.0])),
              "c": torch.full((2, 2), 0.5, dtype=torch.bfloat16)}
    got = topt.global_norm(ttree_)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(jopt.global_norm(jtree)), rel=1e-6)


@pytest.mark.parametrize("variant", ["adamw/fp32", "adamw/int8", "adagrad/fp32",
                                     "adagrad/bf16", "sm3/fp32", "sm3/bf16", "sgd/fp32"])
def test_head_state_bytes_match_jax(variant):
    """``head_state_bytes`` against the JAX package's for each variant, on
    ``meta`` tensors (nothing allocated) and on real ones alike."""
    name, sd = variant.split("/")
    c, k = 4096, 64
    pdtype = jnp.bfloat16 if sd == "bf16" else jnp.float32
    tdtype = torch.bfloat16 if sd == "bf16" else torch.float32
    jp = jheads.init_head_params(jax.random.PRNGKey(0), c, k, dtype=pdtype)
    jcfg = jopt.OptimizerConfig(name=name, state_dtype=sd)
    want = jopt.head_state_bytes(*jax.eval_shape(lambda: (jp, jopt.init_opt_state(jcfg, jp))))
    tcfg = topt.OptimizerConfig(name=name, state_dtype=sd)
    for dev in ("meta", "cpu"):
        tp = theads.HeadParams(torch.empty((c, k), dtype=tdtype, device=dev),
                               torch.empty((c,), dtype=tdtype, device=dev))
        state = topt.init_opt_state(tcfg, tp)
        assert topt.head_state_bytes(tp, state) == want, dev
        assert topt.tree_nbytes(tp) + topt.tree_nbytes(state) == want, dev


def test_sm3_bf16_is_4x_smaller_than_adamw_fp32():
    """Mirror of TestStateBytes: sm3/bf16 holds at least 4x fewer bytes than
    adamw/fp32; in a tree with a "head" only the head's leaves count."""
    c, k = 4096, 64

    def state_bytes(name, sd, dtype):
        p = theads.HeadParams(torch.empty((c, k), dtype=dtype, device="meta"),
                              torch.empty((c,), dtype=dtype, device="meta"))
        cfg = topt.OptimizerConfig(name=name, state_dtype=sd)
        return topt.head_state_bytes(p, topt.init_opt_state(cfg, p))

    big = state_bytes("adamw", "fp32", torch.float32)
    small = state_bytes("sm3", "bf16", torch.bfloat16)
    assert big / small >= 4.0, (big, small)
    tree = {"trunk": torch.zeros((8, 8)),
            "head": {"w": torch.zeros((4, 2)), "b": torch.zeros((4,))}}
    assert topt.head_state_bytes(tree, None) == (4 * 2 + 4) * 4
