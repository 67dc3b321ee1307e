"""The port's training slice against the JAX package: synthetic data, tree
fitting, the samplers' draws, the sparse sampled-head loss, the sparse-row
gradient, the Adagrad and SGD updates, and the whole pipeline.

Inputs are made from a seed with numpy (or the JAX side's own draws) and
given to both packages; the JAX side runs under ``jax.jit``. Tolerances:
float32 1e-5 absolute + 1e-5 relative for losses, metrics, gradients and
dh; 1e-4 absolute for parameters after several Adagrad steps (the first
step is -lr·g/(|g|+eps), which amplifies float32 noise where |g| is near
eps). The reference's bit-exact claims (sparse == dense) are held as
properties of the port, torch against torch.
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
from repro.core import tree_fit as jfit
from repro.core import xc_train as jxc
from repro.data import synthetic as jsyn
from repro.optim import optimizers as jopt
from repro.optim import sparse as jsparse
from repro_torch import convert
from repro_torch.core import heads as theads
from repro_torch.core import samplers as tsamplers
from repro_torch.core import tree as ttree
from repro_torch.core import tree_fit as tfit
from repro_torch.core import xc_train as txc
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels.sampled_loss import SAMPLED_KINDS
from repro_torch.optim import optimizers as topt
from repro_torch.optim import sparse as tsparse

TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-4, rtol=0)
C, KDIM, KG, T = 24, 12, 4, 48       # tiny C: collisions at n_neg > 1


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a)).to(dtype) if dtype else torch.from_numpy(np.array(a))


def _problem(seed=0, c=C, t=T):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, KDIM)).astype(np.float32)
    xg = rng.standard_normal((t, KG)).astype(np.float32)
    y = rng.integers(0, c, t)
    w = (0.3 * rng.standard_normal((c, KDIM))).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return h, xg, y, w, b


def _generators(kind, c=C):
    """The same generator in both packages: a tree (JAX-initialized, carried
    across) or unigram frequencies."""
    if kind == "freq_ns":
        counts = np.arange(1, c + 1, dtype=np.float32)
        return (jheads.make_freq_generator(jnp.asarray(counts)),
                theads.make_freq_generator(counts, device="cpu"))
    jt = jtree.init_tree(jax.random.PRNGKey(0), c, KG, scale=0.5)
    return (jheads.Generator(tree=jt),
            convert.generator_from_numpy(tree=[np.asarray(a) for a in jt],
                                         device="cpu"))


# ---------------------------------------------------------------------------
# Data and tree fitting.
# ---------------------------------------------------------------------------

def test_make_clustered_xc_is_bit_equal():
    spec_kw = dict(num_labels=100, feature_dim=16, seed=3)
    want = jsyn.make_clustered_xc(jsyn.ClusteredXCSpec(**spec_kw), 500, 200)
    got = tsyn.make_clustered_xc(tsyn.ClusteredXCSpec(**spec_kw), 500, 200)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def fitted_trees():
    spec = tsyn.ClusteredXCSpec(num_labels=128, feature_dim=32, seed=0)
    x, y, x_te, y_te = tsyn.make_clustered_xc(spec, 2000, 500)
    proj, mean = tfit.pca_projection(x, 8)
    jproj, jmean = jfit.pca_projection(x, 8)
    np.testing.assert_array_equal(proj, jproj)
    xg, xg_te = (x - mean) @ proj, (x_te - mean) @ proj
    cfg = dict(reg=0.1, seed=0)
    return (tfit.fit_tree(xg, y, 128, config=tfit.FitConfig(**cfg), device="cpu"),
            jfit.fit_tree(xg, y, 128, config=jfit.FitConfig(**cfg)), xg_te, y_te)


def test_fit_tree_matches_jax(fitted_trees):
    tree, jt, xg_te, y_te = fitted_trees
    ttree.validate(tree, 128)
    assert tree.label_to_leaf.dtype == torch.int64
    np.testing.assert_array_equal(tree.label_to_leaf.numpy(), np.asarray(jt.label_to_leaf))
    np.testing.assert_array_equal(tree.leaf_to_label.numpy(), np.asarray(jt.leaf_to_label))
    np.testing.assert_allclose(tree.w.numpy(), np.asarray(jt.w), **TOL)
    ll = tfit.tree_log_likelihood(tree, xg_te, y_te)
    assert ll == pytest.approx(jfit.tree_log_likelihood(jt, xg_te, y_te), abs=1e-5)
    assert ll > -np.log(128)          # better than the uniform proposal


# ---------------------------------------------------------------------------
# Samplers: the JAX side's uniforms give the JAX side's draws.
# ---------------------------------------------------------------------------

def test_tree_sample_with_jax_uniforms_matches_jax(fitted_trees):
    tree, jt, xg_te, _ = fitted_trees
    x = xg_te[:200].astype(np.float32)
    key = jax.random.PRNGKey(4)
    shape = (200, 3)
    want_ids, want_lp = jax.jit(jsamplers.TreeSampler(jt).sample, static_argnums=2)(
        key, jnp.asarray(x), shape)
    u = jax.random.uniform(key, shape + (jt.w.shape[0].bit_length(),), jnp.float32)
    ids, lp = tsamplers.TreeSampler(tree).sample(None, _t(x), shape, u=_t(u))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), **TOL)


def test_unigram_sample_with_jax_uniforms_matches_jax():
    counts = np.array([5, 0, 3, 0, 0, 2, 0, 7, 1, 0], np.float32)
    js = jsamplers.unigram_from_counts(jnp.asarray(counts))
    ts = tsamplers.UnigramSampler(freq_log=_t(js.freq_log), freq_cdf=_t(js.freq_cdf))
    key = jax.random.PRNGKey(8)
    shape = (64, 5)
    want_ids, want_lp = js.sample(key, None, shape)
    ids, lp = ts.sample(None, None, shape, u=_t(jax.random.uniform(key, shape)))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(lp.numpy(), np.asarray(want_lp))
    assert not np.isin(ids.numpy(), np.flatnonzero(counts == 0)).any()


@pytest.mark.parametrize("kind", ["tree", "uniform", "unigram"])
def test_sample_frequencies_match_log_prob(fitted_trees, kind):
    """Chi-square goodness of fit of draws against exp(log_prob_all), as
    tests/test_samplers.py does for the JAX package."""
    tree, _, xg_te, _ = fitted_trees
    c = 128
    sampler = {"tree": tsamplers.TreeSampler(tree),
               "uniform": tsamplers.UniformSampler(c),
               "unigram": tsamplers.unigram_from_counts(
                   np.arange(c, dtype=np.float32) % 7, device="cpu")}[kind]
    x = _t(xg_te[:1].astype(np.float32))
    p = torch.exp(sampler.log_prob_all(x))[0].double().numpy()
    p /= p.sum()
    n = 40_000
    gen = torch.Generator().manual_seed(5)
    ids, lp = sampler.sample(gen, x, (1, n))
    np.testing.assert_allclose(lp[0].numpy(), np.log(p[ids[0].numpy()]), atol=1e-4)
    obs = np.bincount(ids[0].numpy(), minlength=c).astype(np.float64)
    exp = n * p
    keep = exp >= 5.0
    chi2 = float((((obs - exp) ** 2 / np.maximum(exp, 1e-12))[keep]).sum())
    assert obs[exp < 1e-6].sum() == 0
    dof = int(keep.sum()) - 1
    assert chi2 < dof + 5.0 * np.sqrt(2.0 * dof), (chi2, dof)


# ---------------------------------------------------------------------------
# The sparse loss on the JAX package's candidates, and the row gradient.
# ---------------------------------------------------------------------------

def test_accumulate_rows_matches_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 6, (40, 3))
    ids[::4, 2] = ids[::4, 0]                  # negatives equal to the positive
    ids[1::4, 2] = ids[1::4, 1]                # duplicate negatives
    coeff = rng.standard_normal(ids.shape).astype(np.float32)
    h = np.repeat(rng.standard_normal((40, 5)).astype(np.float32), 3, axis=0)
    rows = tsparse.accumulate_rows(_t(ids.reshape(-1)), _t(coeff.reshape(-1)), _t(h), 20)
    jrows = jax.jit(jsparse.accumulate_rows, static_argnums=3)(
        jnp.asarray(ids.reshape(-1), jnp.int32), jnp.asarray(coeff.reshape(-1)),
        jnp.asarray(h), 20)
    assert torch.equal(rows.ids, torch.unique(rows.ids))
    assert rows.ids.numel() == len(np.unique(ids))
    got, want = tsparse.to_dense(rows, (20, 5)), jsparse.to_dense(jrows, (20, 5))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert float(tsparse.sq_norm(rows)) == pytest.approx(float(jsparse.sq_norm(jrows)),
                                                         rel=1e-5)


@pytest.mark.parametrize("kind", SAMPLED_KINDS)
def test_sparse_head_loss_on_jax_candidates_matches_jax(kind):
    h, xg, y, w, b = _problem(seed=2)
    jgen, _ = _generators(kind)
    cfg_kw = dict(num_labels=C, kind=kind, n_neg=4, reg=1e-3)
    jcfg, tcfg = jheads.HeadConfig(**cfg_kw), theads.HeadConfig(**cfg_kw)
    mask = (np.arange(T) % 3 > 0).astype(np.float32)
    key = jax.random.PRNGKey(7)
    args = (jheads.HeadParams(jnp.asarray(w), jnp.asarray(b)), jgen, jnp.asarray(h),
            jnp.asarray(xg), jnp.asarray(y, jnp.int32), key)
    want_loss, want_met, want_rows, want_dh = jax.jit(functools.partial(
        jheads.sparse_head_loss, jcfg, use_kernel=False))(*args, mask=jnp.asarray(mask))
    ids, slot_logp, _ = jax.jit(functools.partial(jheads._sample_candidates, jcfg))(
        jgen, jnp.asarray(xg), jnp.asarray(y, jnp.int32), key)
    loss, met, rows, dh = theads.sparse_candidate_loss(
        tcfg, theads.HeadParams(_t(w), _t(b)), _t(h), _t(ids, torch.int64),
        _t(slot_logp), mask=_t(mask))
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5, abs=1e-5)
    assert set(met) == set(want_met)
    for k in met:
        assert float(met[k]) == pytest.approx(float(want_met[k]), rel=1e-5, abs=1e-5), k
    for g, wnt in zip(tsparse.to_dense(rows, (C, KDIM)),
                      jsparse.to_dense(want_rows, (C, KDIM))):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), **TOL)


def _dense_and_sparse(kind, n_neg, params, tgen, h, xg, y, seed, mask=None):
    cfg = theads.HeadConfig(num_labels=C, kind=kind, n_neg=n_neg, reg=1e-3)
    leaves = theads.HeadParams(*(p.clone().requires_grad_() for p in params))
    hh = h.clone().requires_grad_()
    loss_d, met_d = theads.head_loss(cfg, leaves, tgen, hh, xg, y,
                                     torch.Generator().manual_seed(seed), mask=mask)
    gw, gb, gh = torch.autograd.grad(loss_d, (*leaves, hh))
    sparse = theads.sparse_head_loss(cfg, params, tgen, h, xg, y,
                                     torch.Generator().manual_seed(seed), mask=mask)
    return (loss_d, met_d, theads.HeadParams(gw, gb), gh), sparse


@pytest.mark.parametrize("n_neg", [1, 4])
@pytest.mark.parametrize("kind", SAMPLED_KINDS)
def test_sparse_grads_match_dense_autograd(kind, n_neg):
    h, xg, y, w, b = (_t(a) for a in _problem(seed=3))
    _, tgen = _generators(kind)
    mask = (torch.arange(T) % 3 > 0).float()
    (loss_d, met_d, gd, gh), (loss_s, met_s, rows, dh) = _dense_and_sparse(
        kind, n_neg, theads.HeadParams(w, b), tgen, h, xg, y, 9, mask)
    torch.testing.assert_close(loss_s, loss_d.detach(), rtol=1e-6, atol=1e-7)
    for k in met_d:
        torch.testing.assert_close(met_s[k], met_d[k], rtol=1e-5, atol=1e-7)
    dw, db = tsparse.to_dense(rows, (C, KDIM))
    torch.testing.assert_close(dw, gd.w, rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(db, gd.b, rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(dh, gh, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("opt_name,kind,n_neg", [
    ("adagrad", "adversarial_ns", 1), ("adagrad", "sampled_softmax", 4),
    ("adagrad", "ove", 4), ("sgd", "adversarial_ns", 2), ("sgd", "nce", 2)])
def test_sparse_updates_match_dense_over_steps(opt_name, kind, n_neg):
    h, xg, y, w, b = (_t(a) for a in _problem(seed=4))
    _, tgen = _generators(kind)
    ocfg = topt.OptimizerConfig(name=opt_name, learning_rate=0.1, clip_norm=1.0)
    pd = theads.HeadParams(w.clone(), b.clone())
    ps = theads.HeadParams(w.clone(), b.clone())
    sd, ss = topt.init_opt_state(ocfg, pd), topt.init_opt_state(ocfg, ps)
    touched = set()
    for s in range(5):
        (_, _, gd, _), (_, _, rows, _) = _dense_and_sparse(kind, n_neg, pd, tgen, h,
                                                           xg, y, 100 + s)
        touched |= set(rows.ids.tolist())
        pd, sd, _ = topt.apply_updates(ocfg, pd, gd, sd)
        ps_before = ps
        ps, ss, _ = topt.apply_updates(ocfg, ps, rows, ss)
        assert ps.w is ps_before.w                 # the rows were written in place
    assert ss.step == 5
    rows_t = sorted(touched)
    torch.testing.assert_close(ps.w[rows_t], pd.w[rows_t], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ps.b[rows_t], pd.b[rows_t], rtol=1e-5, atol=1e-6)
    untouched = sorted(set(range(C)) - touched)
    assert torch.equal(ps.w[untouched], w[untouched])


# ---------------------------------------------------------------------------
# apply_updates, global norm and clipping against the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_name,grad_form,extra", [
    ("adagrad", "sparse", {}),
    ("adagrad", "dense", dict(clip_norm=0.5, warmup_steps=5, decay_steps=20)),
    ("sgd", "sparse", dict(clip_norm=0.5, warmup_steps=5, decay_steps=20)),
    ("sgd", "dense", {})])
def test_apply_updates_matches_jax(opt_name, grad_form, extra):
    rng = np.random.default_rng(6)
    _, _, _, w, b = _problem(seed=6)
    nu = (np.abs(rng.standard_normal(w.shape)).astype(np.float32),
          np.abs(rng.standard_normal(b.shape)).astype(np.float32))
    ids = np.array([0, 3, 4, 9, 17])
    dw = rng.standard_normal((5, KDIM)).astype(np.float32)
    db = rng.standard_normal(5).astype(np.float32)
    kw = dict(name=opt_name, learning_rate=0.05, **extra)
    jcfg, tcfg = jopt.OptimizerConfig(**kw), topt.OptimizerConfig(**kw)
    jparams = jheads.HeadParams(jnp.asarray(w), jnp.asarray(b))
    jnu = jheads.HeadParams(jnp.asarray(nu[0]), jnp.asarray(nu[1])) if opt_name == "adagrad" else None
    jstate = jopt.OptState(step=jnp.asarray(3, jnp.int32), mu=None, nu=jnu)
    tstate = convert.opt_state_from_numpy(3, nu if opt_name == "adagrad" else None,
                                          device="cpu")
    if grad_form == "sparse":
        jgrads = jsparse.SparseRows(jnp.asarray(ids, jnp.int32), jnp.asarray(dw),
                                    jnp.asarray(db))
        tgrads = tsparse.SparseRows(_t(ids), _t(dw), _t(db))
    else:
        gw, gb = np.zeros_like(w), np.zeros_like(b)
        gw[ids], gb[ids] = dw, db
        jgrads = jheads.HeadParams(jnp.asarray(gw), jnp.asarray(gb))
        tgrads = theads.HeadParams(_t(gw), _t(gb))
    want_p, want_s, _ = jax.jit(functools.partial(jopt.apply_updates, jcfg))(
        jparams, jgrads, jstate)
    got_p, got_s, _ = topt.apply_updates(tcfg, theads.HeadParams(_t(w), _t(b)),
                                         tgrads, tstate)
    assert got_s.step == int(want_s.step) == 4
    for g, wnt in zip(got_p, want_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
    if opt_name == "adagrad":
        for g, wnt in zip(got_s.nu, want_s.nu):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
    else:
        assert got_s.nu is None


def test_global_norm_and_clipping_match_jax():
    rng = np.random.default_rng(7)
    trunk = rng.standard_normal((3, 5)).astype(np.float32)
    ids = np.array([1, 4, 6])
    dw = rng.standard_normal((3, KDIM)).astype(np.float32)
    db = rng.standard_normal(3).astype(np.float32)
    jtree_ = {"trunk": jnp.asarray(trunk),
              "head": jsparse.SparseRows(jnp.asarray(ids, jnp.int32), jnp.asarray(dw),
                                         jnp.asarray(db))}
    ttree_ = {"trunk": _t(trunk), "head": tsparse.SparseRows(_t(ids), _t(dw), _t(db))}
    assert float(topt.global_norm(ttree_)) == pytest.approx(
        float(jopt.global_norm(jtree_)), rel=1e-6)
    clipped, norm = topt.clip_by_global_norm(ttree_, 2.0)
    jclipped, jnorm = jopt.clip_by_global_norm(jtree_, 2.0)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    np.testing.assert_allclose(clipped["trunk"].numpy(), np.asarray(jclipped["trunk"]), **TOL)
    np.testing.assert_allclose(clipped["head"].dw.numpy(), np.asarray(jclipped["head"].dw),
                               **TOL)
    np.testing.assert_allclose(clipped["head"].db.numpy(), np.asarray(jclipped["head"].db),
                               **TOL)


@pytest.mark.parametrize("bad", ["adamw", "sm3", "bf16_state", "mesh"])
def test_later_slice_optimizers_raise(bad):
    """Every rule and state dtype is ported; what still raises is the
    vocab-sharded row update (mesh=), which waits for the parallel slice."""
    params = theads.HeadParams(torch.zeros(4, 3), torch.zeros(4))
    cfg = topt.OptimizerConfig(
        name={"adamw": "adamw", "sm3": "sgd"}.get(bad, "adagrad"),
        head_name="sm3" if bad == "sm3" else None,
        state_dtype="bf16" if bad == "bf16_state" else "fp32")
    state = topt.init_opt_state(cfg, params)
    with pytest.raises(NotImplementedError, match="parallel slice"):
        topt.apply_updates(cfg, params, params, state, mesh=object())


# ---------------------------------------------------------------------------
# The whole slice: the paper's pipeline in the port alone, and JAX-trained
# weights carried across.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline_data():
    c = 256
    spec = tsyn.ClusteredXCSpec(num_labels=c, feature_dim=32, seed=0)
    x, y, x_te, y_te = tsyn.make_clustered_xc(spec, 6000, 1500)
    proj, mean = tfit.pca_projection(x, 8)
    xg, xg_te = (x - mean) @ proj, (x_te - mean) @ proj
    return c, (x, xg.astype(np.float32), y), (x_te, xg_te.astype(np.float32), y_te)


def test_paper_pipeline_in_the_port(pipeline_data):
    """Mirror of tests/test_system.py::test_paper_pipeline_end_to_end."""
    c, (x, xg, y), (x_te, xg_te, y_te) = pipeline_data
    tree = tfit.fit_tree(xg, y, c, config=tfit.FitConfig(reg=0.1, seed=0), device="cpu")
    test = (_t(x_te), _t(xg_te), _t(y_te))
    accs = {}
    for kind, gen in [("adversarial_ns", theads.make_tree_generator(tree)),
                      ("uniform_ns", theads.Generator())]:
        cfg = theads.HeadConfig(num_labels=c, kind=kind, n_neg=1, reg=1e-4)
        params = txc.train_linear_head(cfg, gen, x, xg, y, lr=0.1, steps=150,
                                       batch_size=256, device="cpu")
        accs[kind] = float(theads.predictive_accuracy(cfg, params, gen, *test))
        if kind == "adversarial_ns":
            cfg_b = theads.HeadConfig(num_labels=c, kind=kind, debias=False)
            acc_biased = float(theads.predictive_accuracy(cfg_b, params, gen, *test))
            assert accs[kind] > acc_biased + 0.05, (accs[kind], acc_biased)
    assert accs["adversarial_ns"] > accs["uniform_ns"], accs
    assert accs["adversarial_ns"] > 0.3, accs


def test_jax_trained_head_scores_the_same_accuracy(pipeline_data):
    c, (x, xg, y), (x_te, xg_te, y_te) = pipeline_data
    jt = jfit.fit_tree(xg, y, c, config=jfit.FitConfig(reg=0.1, seed=0))
    cfg_kw = dict(num_labels=c, kind="adversarial_ns", reg=1e-4)
    jcfg, tcfg = jheads.HeadConfig(**cfg_kw), theads.HeadConfig(**cfg_kw)
    jgen = jheads.Generator(tree=jt)
    params = jxc.train_linear_head(jcfg, jgen, jnp.asarray(x), jnp.asarray(xg),
                                   jnp.asarray(y, jnp.int32), lr=0.1, steps=60)
    want = float(jax.jit(functools.partial(jheads.predictive_accuracy, jcfg))(
        params, jgen, jnp.asarray(x_te), jnp.asarray(xg_te), jnp.asarray(y_te, jnp.int32)))
    tparams = convert.head_params_from_numpy(np.asarray(params.w), np.asarray(params.b),
                                             device="cpu")
    tgen = convert.generator_from_numpy(tree=[np.asarray(a) for a in jt], device="cpu")
    got = float(theads.predictive_accuracy(tcfg, tparams, tgen, _t(x_te), _t(xg_te),
                                           _t(y_te)))
    assert got == pytest.approx(want, abs=1e-6)
    assert got > 0.3


def test_tune_and_train_picks_from_the_grid(pipeline_data):
    c, (x, xg, y), (x_te, xg_te, y_te) = pipeline_data
    cfg, params, lr = txc.tune_and_train(
        "uniform_ns", theads.Generator(), c, x, xg, y, x_te, xg_te, y_te,
        lr_grid=(0.03, 0.3), steps=60, tune_steps=20, device="cpu")
    assert cfg.kind == "uniform_ns" and lr in (0.03, 0.3)
    assert params.w.shape == (c, 32) and torch.isfinite(params.w).all()
