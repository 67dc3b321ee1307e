"""The port's LM training slice against the JAX package: the LM head losses,
the sparse embedding rows, ``forward(inputs_embeds=)``, the training
attention, the training and evaluation steps, the generator refit's
feature snapshot and projected fit, and ``convert.train_state_from_numpy``;
then the reference's bit-exact claims as properties of the port, torch
against torch.

The model is reduced stablelm-3b with one layer in float32, as
``tests/test_train_loop.py::_setup``, plus one bfloat16 case. The JAX side
runs under ``jax.jit``; its ``init_train_state`` is carried across with
``convert.train_state_from_numpy``. Sampling differs between the packages
(threefry against Philox), so the steps are held on fixed candidates: both
packages take the same test-only sampler, which returns given ids and
log-probabilities for each step (read from the JAX key's counter word and
from the torch generator's seed).

Tolerances:
- losses, metrics, ``SparseRows``, dh and embedding rows: 1e-5 absolute +
  1e-5 relative (float32 sums in another order);
- parameters and optimizer state after three Adagrad steps: 1e-4
  absolute, the bound ``tests/test_torch_train.py`` justifies (Adagrad's
  first step is -lr·g/(|g| + eps), which amplifies float32 noise where |g|
  is near eps);
- bfloat16 (one SGD step, so the update is lr times the gradient): loss
  within 2e-2 relative, parameters within 2e-3 absolute (a bfloat16 ulp is
  2^-8 relative, rounded at every matmul and residual add, and the
  gradients are rounded to bfloat16 on their way back through the trunk).
"""
import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.heads import HeadParams as JHeadParams
from repro.models import lm_head as jlm_head
from repro.models import transformer as jtransformer
from repro.optim import OptimizerConfig as JOptimizerConfig
from repro.optim import sparse as jsparse
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import convert, tree_util
from repro_torch.core.heads import HeadParams
from repro_torch.kernels.sampled_loss import SAMPLED_KINDS
from repro_torch.models import lm_head as tlm_head
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import OptimizerConfig
from repro_torch.optim import sparse as tsparse
from repro_torch.train import step as tstep

TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-4, rtol=0)
BF16_LOSS_RTOL = 2e-2
BF16_PARAM_ATOL = 2e-3
B, S, N_STEPS = 4, 16, 3
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The model here is tiny: one thread per op is as fast, and leaves the
    other test workers' cores alone (the default spins a thread per core
    in every op)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(dtype="float32", **kw):
    base = dataclasses.replace(jconfigs.reduced_config("stablelm-3b"), num_layers=1,
                               dtype=dtype, **kw)
    port = dataclasses.replace(tconfigs.reduced_config("stablelm-3b"), num_layers=1,
                               dtype=dtype, **kw)
    return base, port


def _batch(cfg, step, seed=0):
    rng = np.random.default_rng((seed, step))
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[0, -3:] = 0.0                  # a masked tail: the loss's denominator
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _candidates(cfg, n_neg, steps=N_STEPS, seed=5):
    """Fixed negatives (steps, B, S, n_neg) and a per-label log-prob table."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (steps, B, S, n_neg)).astype(np.int32)
    ids[:, 0, :2, 0] = 3                # collisions: a duplicated row
    table = np.log(rng.dirichlet(np.ones(cfg.vocab_size))).astype(np.float32)
    return ids, table


class JFixed(NamedTuple):
    """Test-only JAX sampler: step s = the key's counter word."""
    ids: jax.Array
    table: jax.Array

    def sample(self, rng, x_gen, shape):
        ids = jnp.take(self.ids, rng[1], axis=0).reshape(shape)
        return ids, self.table[ids]

    def log_prob(self, x_gen, y):
        return self.table[y]

    def log_prob_all(self, x_gen):
        return jnp.broadcast_to(self.table, x_gen.shape[:-1] + self.table.shape)


class TFixed:
    """The same sampler for the port: step s = the generator's seed."""

    def __init__(self, ids, table):
        self.ids = torch.as_tensor(ids).long()
        self.table = torch.as_tensor(table)

    def sample(self, generator, x_gen, shape, u=None):
        ids = self.ids[generator.initial_seed()].reshape(shape)
        return ids, self.table[ids]

    def log_prob(self, x_gen, y):
        return self.table[y.long()]

    def log_prob_all(self, x_gen):
        return self.table.expand(x_gen.shape[:-1] + self.table.shape)


def _samplers(cfg, n_neg=1):
    ids, table = _candidates(cfg, n_neg)
    return JFixed(jnp.asarray(ids), jnp.asarray(table)), TFixed(ids, table)


def _gen(s):
    return torch.Generator().manual_seed(s)


@functools.lru_cache(maxsize=None)
def _jax_state(dtype, opt_name="adagrad", head_name=None, state_dtype="fp32"):
    jcfg, _ = _cfg(dtype)
    opt = JOptimizerConfig(name=opt_name, learning_rate=0.05, clip_norm=1.0,
                           head_name=head_name, state_dtype=state_dtype)
    return jstep.init_train_state(jax.random.PRNGKey(0), jcfg, opt, "adversarial_ns")


def _port_state(jstate):
    return convert.train_state_from_numpy(jax.tree.map(np.asarray, jstate), device=CPU)


def _assert_tree_close(got_tree, want_jax_tree, tol, what):
    """A port tree against the JAX tree it mirrors (layers stacked there)."""
    want = convert._lm_tree(jax.tree.map(np.asarray, want_jax_tree), torch.device(CPU),
                            n_layers=1)
    got_l, got_s = tree_util.flatten(got_tree)
    want_l, want_s = tree_util.flatten(want)
    assert got_s == want_s, what
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **tol,
                                   err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------

def _head_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = (0.3 * rng.standard_normal((cfg.padded_vocab, cfg.d_model))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cfg.padded_vocab)).astype(np.float32)
    return h, w, bias


@pytest.mark.parametrize("kind", ("softmax",) + SAMPLED_KINDS)
def test_lm_head_loss_every_kind_matches_jax(kind):
    jcfg, tcfg = _cfg()
    js, ts = _samplers(jcfg, n_neg=2)
    hcfg_j = jlm_head.head_config(jcfg, kind, n_neg=2, reg=1e-3)
    hcfg_t = tlm_head.head_config(tcfg, kind, n_neg=2, reg=1e-3)
    jstate = _jax_state("float32")
    hs_j, hs_t = jstate.head_state, _port_state(jstate).head_state
    h, w, bias = _head_inputs(jcfg)
    b = _batch(jcfg, 0)
    fn = jax.jit(lambda h, w, bb, y, m: jlm_head.lm_head_loss(
        jcfg, hcfg_j, JHeadParams(w=w, b=bb), hs_j, h, y, jax.random.PRNGKey(1),
        mask=m, sampler=js))
    want_loss, want_m = fn(h, w, bias, b["labels"], b["mask"])
    got_loss, got_m = tlm_head.lm_head_loss(
        tcfg, hcfg_t, HeadParams(torch.as_tensor(w), torch.as_tensor(bias)), hs_t,
        torch.as_tensor(h), torch.as_tensor(b["labels"]), _gen(1),
        mask=torch.as_tensor(b["mask"]), sampler=ts)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **TOL)
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), **TOL, err_msg=k)


@pytest.mark.parametrize("kind", SAMPLED_KINDS)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_lm_sparse_head_loss_matches_jax(kind, softcap):
    jcfg, tcfg = _cfg(final_logit_softcap=softcap)
    js, ts = _samplers(jcfg, n_neg=2)
    hcfg_j = jlm_head.head_config(jcfg, kind, n_neg=2, reg=1e-3)
    hcfg_t = tlm_head.head_config(tcfg, kind, n_neg=2, reg=1e-3)
    jstate = _jax_state("float32")
    hs_j, hs_t = jstate.head_state, _port_state(jstate).head_state
    h, w, bias = _head_inputs(jcfg, seed=1)
    b = _batch(jcfg, 1)
    fn = jax.jit(lambda h, w, bb, y, m: jlm_head.lm_sparse_head_loss(
        jcfg, hcfg_j, JHeadParams(w=w, b=bb), hs_j, h, y, jax.random.PRNGKey(2),
        mask=m, sampler=js))
    w_loss, w_m, w_rows, w_dh = fn(h, w, bias, b["labels"], b["mask"])
    g_loss, g_m, g_rows, g_dh = tlm_head.lm_sparse_head_loss(
        tcfg, hcfg_t, HeadParams(torch.as_tensor(w), torch.as_tensor(bias)), hs_t,
        torch.as_tensor(h), torch.as_tensor(b["labels"]), _gen(2),
        mask=torch.as_tensor(b["mask"]), sampler=ts)
    np.testing.assert_allclose(float(g_loss), float(w_loss), **TOL)
    for k in w_m:
        np.testing.assert_allclose(float(g_m[k]), float(w_m[k]), **TOL, err_msg=k)
    want_dw, want_db = jsparse.to_dense(w_rows, w.shape)
    got_dw, got_db = tsparse.to_dense(g_rows, w.shape)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), **TOL)
    np.testing.assert_allclose(got_db.numpy(), np.asarray(want_db), **TOL)
    live = np.asarray(w_rows.ids)
    assert sorted(g_rows.ids.tolist()) == sorted(set(live[live < w.shape[0]].tolist()))
    np.testing.assert_allclose(g_dh.numpy(), np.asarray(w_dh), **TOL)


def test_accumulate_embed_rows_matches_jax():
    rng = np.random.default_rng(0)
    v, d, t = 32, 8, 50
    ids = rng.integers(0, v, t).astype(np.int32)          # duplicates
    dh = rng.standard_normal((t, d)).astype(np.float32)
    want = jsparse.accumulate_embed_rows(jnp.asarray(ids), jnp.asarray(dh), v)
    got = tsparse.accumulate_embed_rows(torch.as_tensor(ids), torch.as_tensor(dh), v)
    assert got.db is None and want.db is None
    assert torch.equal(got.ids, torch.unique(got.ids))
    want_dw, _ = jsparse.to_dense(want, (v, d))
    got_dw, _ = tsparse.to_dense(got, (v, d))
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), **TOL)
    dense = torch.zeros(v, d).index_add_(0, torch.as_tensor(ids).long(), torch.as_tensor(dh))
    np.testing.assert_allclose(got_dw.numpy(), dense.numpy(), **TOL)


# ---------------------------------------------------------------------------
# The model: forward(inputs_embeds=), remat, the training attention
# ---------------------------------------------------------------------------

def test_forward_inputs_embeds_matches_tokens_and_jax():
    jcfg, tcfg = _cfg()
    jstate = _jax_state("float32")
    params = _port_state(jstate).params
    toks = _batch(jcfg, 2)["tokens"]
    t = torch.as_tensor(toks)
    want, _, _ = ttransformer.forward(params, tcfg, t, attn_impl="plain")
    h0 = params["embed"][t.long()].to(torch.float32)
    got, _, _ = ttransformer.forward({k: v for k, v in params.items() if k != "embed"},
                                     tcfg, t, inputs_embeds=h0, attn_impl="plain")
    assert torch.equal(got, want)
    jfwd = jax.jit(lambda p, tk, e: jtransformer.forward(p, jcfg, tk, inputs_embeds=e)[0])
    jh = jfwd(jstate.params, jnp.asarray(toks),
              jnp.take(jstate.params["embed"], jnp.asarray(toks), axis=0))
    np.testing.assert_allclose(got.numpy(), np.asarray(jh), atol=2e-4, rtol=2e-4)
    kern, _, _ = ttransformer.forward(params, tcfg, t)      # the kernel's plain version
    np.testing.assert_allclose(kern.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["gemma2-27b", "h2o-danube-3-4b"])
def test_plain_attention_forward_matches_jax(arch):
    """The training attention on the softcap, window and GQA geometries."""
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), dtype="float32")
    params = jtransformer.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), device=CPU)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 16))
    want = jax.jit(lambda p, tk: jtransformer.forward(p, jcfg, tk)[0])(params, toks)
    got, _, _ = ttransformer.forward(tparams, tcfg, torch.as_tensor(toks), attn_impl="plain")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_remat_on_and_off_give_the_same_bits():
    _, tcfg = _cfg()
    _, ts = _samplers(tcfg)
    hcfg = tlm_head.head_config(tcfg, "adversarial_ns", reg=1e-4)
    b = _tbatch(_batch(tcfg, 0))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat, num_layers=2)
        st = tstep.init_train_state(_gen(4), cfg, OptimizerConfig(), "adversarial_ns",
                                   device=CPU)
        grads, metrics = tstep.make_grad_fn(cfg, hcfg, sampler=ts)(st, b, _gen(0))
        out.append((tree_util.flatten(grads)[0], metrics))
    for g0, g1 in zip(out[0][0], out[1][0]):
        assert torch.equal(g0, g1)
    assert torch.equal(out[0][1]["loss"], out[1][1]["loss"])


# ---------------------------------------------------------------------------
# The training step against JAX on fixed candidates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_update,embed_update", [
    ("sparse", "sparse"), ("sparse", "dense"), ("dense", "dense")])
def test_three_train_steps_match_jax(head_update, embed_update):
    jcfg, tcfg = _cfg()
    js, ts = _samplers(jcfg)
    jh = jlm_head.head_config(jcfg, "adversarial_ns", reg=1e-4)
    th = tlm_head.head_config(tcfg, "adversarial_ns", reg=1e-4)
    jopt = JOptimizerConfig(name="adagrad", learning_rate=0.05, clip_norm=1.0)
    topt = OptimizerConfig(name="adagrad", learning_rate=0.05, clip_norm=1.0)
    jstate = _jax_state("float32")
    tstate = _port_state(jstate)
    jfn = jax.jit(jstep.make_train_step(jcfg, jh, jopt, head_update=head_update,
                                        sampler=js, embed_update=embed_update))
    tfn = tstep.make_train_step(tcfg, th, topt, head_update=head_update, sampler=ts,
                                embed_update=embed_update)
    for s in range(N_STEPS):
        b = _batch(jcfg, s)
        jstate, jm = jfn(jstate, _jbatch(b), jax.random.PRNGKey(s))
        tstate, tm = tfn(tstate, _tbatch(b), _gen(s))
        for k in ("loss", "grad_norm", "snr_proxy", "snr_ewma", "pos_score"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL, err_msg=k)
    assert tstate.step == int(jstate.step) == N_STEPS
    _assert_tree_close(tstate.params, jstate.params, PARAM_TOL, "params")
    _assert_tree_close(tstate.opt_state.nu, jstate.opt_state.nu, PARAM_TOL, "adagrad nu")
    np.testing.assert_allclose(float(tstate.snr_ewma), float(jstate.snr_ewma), **TOL)


def test_train_step_bfloat16_matches_jax():
    jcfg, tcfg = _cfg("bfloat16")
    js, ts = _samplers(jcfg)
    jh = jlm_head.head_config(jcfg, "adversarial_ns", reg=1e-4)
    th = tlm_head.head_config(tcfg, "adversarial_ns", reg=1e-4)
    jopt = JOptimizerConfig(name="sgd", learning_rate=0.05, clip_norm=1.0)
    topt = OptimizerConfig(name="sgd", learning_rate=0.05, clip_norm=1.0)
    jstate = _jax_state("bfloat16", opt_name="sgd")
    tstate = _port_state(jstate)
    b = _batch(jcfg, 0)
    jstate, jm = jax.jit(jstep.make_train_step(jcfg, jh, jopt, sampler=js))(
        jstate, _jbatch(b), jax.random.PRNGKey(0))
    tstate, tm = tstep.make_train_step(tcfg, th, topt, sampler=ts)(tstate, _tbatch(b), _gen(0))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=BF16_LOSS_RTOL)
    _assert_tree_close(tstate.params, jstate.params, dict(atol=BF16_PARAM_ATOL, rtol=0),
                       "bf16 params")


def test_eval_step_matches_jax():
    jcfg, tcfg = _cfg()
    jh = jlm_head.head_config(jcfg, "adversarial_ns")
    th = tlm_head.head_config(tcfg, "adversarial_ns")
    jstate = _jax_state("float32")
    b = _batch(jcfg, 7)
    want = jax.jit(jstep.make_eval_step(jcfg, jh))(jstate, _jbatch(b))
    got = tstep.make_eval_step(tcfg, th)(_port_state(jstate), _tbatch(b))
    for k in ("eval_loglik", "eval_acc"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=2e-4, rtol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("opt_name,head_name,state_dtype", [
    ("adagrad", None, "fp32"), ("adagrad", "adamw", "int8"), ("sgd", "sm3", "bf16")])
def test_train_state_from_numpy(opt_name, head_name, state_dtype):
    jstate = _jax_state("float32", opt_name, head_name, state_dtype)
    got = _port_state(jstate)
    assert (got.step, got.gen_fit_step) == (0, -1)
    assert float(got.snr_ewma) == float(got.snr_ref) == -1.0
    _assert_tree_close(got.params, jstate.params, dict(atol=0, rtol=0), "params")
    for field in ("mu", "nu", "last"):
        want = getattr(jstate.opt_state, field)
        if want is None:
            assert getattr(got.opt_state, field) is None
        else:
            _assert_tree_close(getattr(got.opt_state, field), want, dict(atol=0, rtol=0),
                               field)
    np.testing.assert_array_equal(got.head_state.proj.numpy(),
                                  np.asarray(jstate.head_state.proj))
    for g, w in zip(got.head_state.gen.tree, jstate.head_state.gen.tree):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The port's own init has the same structure and dtypes.
    _, tcfg = _cfg()
    topt = OptimizerConfig(name=opt_name, learning_rate=0.05, clip_norm=1.0,
                           head_name=head_name, state_dtype=state_dtype)
    own = tstep.init_train_state(_gen(0), tcfg, topt, "adversarial_ns", device=CPU)
    own_l, own_s = tree_util.flatten(own.opt_state)
    got_l, got_s = tree_util.flatten(got.opt_state)
    assert own_s == got_s
    assert [x.dtype for x in own_l[1:]] == [x.dtype for x in got_l[1:]]


def test_collect_features_and_projected_fit_match_jax():
    """The generator refit's glue: the snapshot's hiddens against JAX's
    (2e-4, the forward's float32 tolerance), and, on the same numpy
    features, the PCA-projected fit with its centering folded into the node
    biases (the sequential fitter, float64 numpy on both sides: 1e-5)."""
    from repro.core.tree_fit import FitConfig as JFitConfig
    from repro.train import generator_fit as jgf
    from repro_torch.core.tree_fit import FitConfig
    from repro_torch.train import generator_fit as tgf
    jcfg, tcfg = _cfg()
    jstate = _jax_state("float32")
    batches = [_batch(jcfg, 20 + i) for i in range(2)]
    want_h, want_y = jgf.collect_features(jstate.params, jcfg, batches, max_tokens=100)
    got_h, got_y = tgf.collect_features(_port_state(jstate).params, tcfg, batches,
                                        max_tokens=100)
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_allclose(got_h, want_h, atol=2e-4, rtol=2e-4)
    feats = np.asarray(want_h, np.float32)
    want_tree, want_proj = jgf._fit_projected_tree(feats, want_y, jcfg, JFitConfig(reg=0.1),
                                                   "sequential")
    got_tree, got_proj = tgf._fit_projected_tree(feats, want_y, tcfg, FitConfig(reg=0.1),
                                                 "sequential", torch.device(CPU))
    np.testing.assert_array_equal(got_proj.numpy(), np.asarray(want_proj))
    for g, w in zip(got_tree, want_tree):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# The reference's bit-exact claims, torch against torch
# ---------------------------------------------------------------------------

def test_sparse_embed_matches_dense_embed():
    """``tests/test_state_memory.py:329``: three steps with the embedding
    table updated from SparseRows against its dense autograd gradient."""
    cfg = tconfigs.reduced_config("stablelm-3b")
    cfg = dataclasses.replace(cfg, num_layers=2, d_model=32, d_ff=64, vocab_size=128,
                              num_heads=2, num_kv_heads=2, vocab_pad_multiple=64,
                              gen_feature_dim=8, dtype="float32")
    hcfg = tlm_head.head_config(cfg, "adversarial_ns", n_neg=2, reg=1e-4)
    opt = OptimizerConfig(name="adagrad", learning_rate=0.05, clip_norm=1.0)
    from repro_torch.data import lm_batch_fn
    make = lm_batch_fn(cfg.vocab_size, 4, 16, seed=0)
    states, fns = [], []
    for embed_update in ("dense", "sparse"):
        states.append(tstep.init_train_state(_gen(0), cfg, opt, "adversarial_ns",
                                             device=CPU))
        fns.append(tstep.make_train_step(cfg, hcfg, opt, head_update="sparse",
                                         embed_update=embed_update))
    for s in range(3):
        b = _tbatch(make(s))
        states[0], md = fns[0](states[0], b, _gen(100 + s))
        states[1], ms = fns[1](states[1], b, _gen(100 + s))
        np.testing.assert_allclose(float(ms["loss"]), float(md["loss"]), rtol=1e-5)
    for a, b in zip(tree_util.flatten(states[0].params)[0],
                    tree_util.flatten(states[1].params)[0]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=5e-3, atol=5e-5)


def test_sparse_head_grads_match_dense_autograd():
    """The sparse path's trunk gradients, SparseRows and embedding rows
    against autograd through the candidate scores, on the same candidates."""
    _, tcfg = _cfg()
    tcfg = dataclasses.replace(tcfg, num_layers=2)
    _, ts = _samplers(tcfg, n_neg=2)
    hcfg = tlm_head.head_config(tcfg, "adversarial_ns", n_neg=2, reg=1e-4)
    st = tstep.init_train_state(_gen(1), tcfg, OptimizerConfig(), "adversarial_ns",
                                device=CPU)
    b = _tbatch(_batch(tcfg, 3))
    sparse, ms = tstep.make_grad_fn(tcfg, hcfg, "sparse", sampler=ts)(st, b, _gen(1))
    dense, md = tstep.make_grad_fn(tcfg, hcfg, "dense", sampler=ts)(st, b, _gen(1))
    np.testing.assert_allclose(float(ms["loss"]), float(md["loss"]), **TOL)
    dw, db = tsparse.to_dense(sparse["head"], st.params["head"]["w"].shape)
    np.testing.assert_allclose(dw.numpy(), dense["head"]["w"].numpy(), **TOL)
    np.testing.assert_allclose(db.numpy(), dense["head"]["b"].numpy(), **TOL)
    de, _ = tsparse.to_dense(sparse["embed"], st.params["embed"].shape)
    np.testing.assert_allclose(de.numpy(), dense["embed"].numpy(), **TOL)
    trunk = {k: v for k, v in sparse.items() if k not in ("head", "embed")}
    want = {k: v for k, v in dense.items() if k not in ("head", "embed")}
    for g, w in zip(tree_util.flatten(trunk)[0], tree_util.flatten(want)[0]):
        assert bool(g.abs().sum() > 0)
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_skip_nonfinite_keeps_every_bit():
    _, tcfg = _cfg()
    _, ts = _samplers(tcfg)
    hcfg = tlm_head.head_config(tcfg, "adversarial_ns", reg=1e-4)
    opt = OptimizerConfig(name="adagrad", learning_rate=0.05, clip_norm=1.0)
    st = tstep.init_train_state(_gen(2), tcfg, opt, "adversarial_ns", device=CPU)
    fn = tstep.make_train_step(tcfg, hcfg, opt, sampler=ts, skip_nonfinite=True)
    st, _ = fn(st, _tbatch(_batch(tcfg, 0)), _gen(0))
    before = [x.clone() if isinstance(x, torch.Tensor) else x
              for x in tree_util.flatten((st.params, st.opt_state, st.snr_ewma))[0]]
    bad = _tbatch(_batch(tcfg, 1))
    bad["mask"][1, 2] = float("nan")
    st2, m = fn(st, bad, _gen(1))
    assert float(m["nonfinite"]) == 1.0 and st2.step == st.step + 1
    after = tree_util.flatten((st2.params, st2.opt_state, st2.snr_ewma))[0]
    for x, y in zip(before, after):
        assert (x == y) if not isinstance(x, torch.Tensor) else torch.equal(x, y)
    st3, m = fn(st2, _tbatch(_batch(tcfg, 2)), _gen(2))
    assert float(m["nonfinite"]) == 0.0 and np.isfinite(float(m["loss"]))
