"""The whole prediction slice: the JAX package fits a tree and trains a head
on synthetic clustered data; the weights are carried across with
``repro_torch.convert``; the port's beam top-k, dense scores and accuracy
must match the JAX package's on the same test set.

Also the port's two package rules: no import of ``jax`` or ``repro`` in
``src/repro_torch/`` and ``chip_smoke.py``, and entry points that default to
the card raise where there is none instead of running on the CPU.
"""
import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heads as jheads
from repro.core import xc_train
from repro.core.tree_fit import FitConfig, fit_tree, pca_projection
from repro.data.synthetic import ClusteredXCSpec, make_clustered_xc
from repro_torch import convert
from repro_torch.core import heads as theads
from repro_torch.core import samplers as tsamplers
from repro_torch.core import tree as ttree
from repro_torch.core import tree_fit as tfit
from repro_torch.core import xc_train as txc
from repro_torch.configs import reduced_config
from repro_torch.models import lm_head as tlm_head
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import OptimizerConfig
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-5)
C, KDIM, KG = 128, 32, 8


@pytest.fixture(scope="module")
def trained():
    """Tree fitted and head trained by the JAX package (a few steps)."""
    spec = ClusteredXCSpec(num_labels=C, feature_dim=KDIM, seed=0)
    x, y, x_te, y_te = make_clustered_xc(spec, 2000, 300)
    proj, mean = pca_projection(x, KG)
    xg, xg_te = (x - mean) @ proj, (x_te - mean) @ proj
    tree = fit_tree(xg, y, C, config=FitConfig(reg=0.1, seed=0))
    cfg = jheads.HeadConfig(num_labels=C, kind="adversarial_ns", reg=1e-4)
    gen = jheads.Generator(tree=tree)
    params = xc_train.train_linear_head(
        cfg, gen, jnp.asarray(x), jnp.asarray(xg, jnp.float32),
        jnp.asarray(y, jnp.int32), lr=0.3, steps=30, batch_size=256)
    test = tuple(np.asarray(a, np.float32) for a in (x_te, xg_te)) + (y_te,)
    return cfg, gen, params, test


@pytest.fixture(scope="module")
def carried(trained):
    cfg, gen, params, _ = trained
    tcfg = theads.HeadConfig(num_labels=cfg.num_labels, kind=cfg.kind, reg=cfg.reg)
    tparams = convert.head_params_from_numpy(np.asarray(params.w),
                                             np.asarray(params.b), device="cpu")
    tgen = convert.generator_from_numpy(tree=[np.asarray(a) for a in gen.tree],
                                        device="cpu")
    return tcfg, tgen, tparams


def test_carried_tree_is_valid(carried):
    _, tgen, _ = carried
    ttree.validate(tgen.tree, C)
    assert tgen.tree.depth == 7


@pytest.mark.parametrize("beam", [16, 128], ids=["beam16", "exhaustive"])
def test_beam_topk_matches_jax(trained, carried, beam):
    cfg, gen, params, (x, xg, _) = trained
    tcfg, tgen, tparams = carried
    fn = jax.jit(functools.partial(jheads.predictive_topk, cfg, topk=5, beam=beam))
    want_top, want_labels = fn(params, gen, jnp.asarray(x), jnp.asarray(xg))
    top, labels = theads.predictive_topk(tcfg, tparams, tgen, torch.from_numpy(x),
                                         torch.from_numpy(xg), 5, beam=beam)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    np.testing.assert_allclose(top.numpy(), np.asarray(want_top), **TOL)


def test_dense_scores_and_accuracy_match_jax(trained, carried):
    cfg, gen, params, (x, xg, y) = trained
    tcfg, tgen, tparams = carried
    args = (params, gen, jnp.asarray(x), jnp.asarray(xg))
    want_scores = jax.jit(functools.partial(jheads.predictive_scores, cfg))(*args)
    want_acc = jax.jit(functools.partial(jheads.predictive_accuracy, cfg))(
        *args, jnp.asarray(y, jnp.int32))
    targs = (tcfg, tparams, tgen, torch.from_numpy(x), torch.from_numpy(xg))
    scores = theads.predictive_scores(*targs)
    acc = theads.predictive_accuracy(*targs, torch.from_numpy(y))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), **TOL)
    assert float(acc) == pytest.approx(float(want_acc), abs=1e-6)
    assert float(acc) > 1.0 / C      # the trained head predicts something


def test_tree_sampler_debias_equals_generator_debias(carried, trained):
    tcfg, tgen, tparams = carried
    _, _, _, (x, xg, _) = trained
    h, xgt = torch.from_numpy(x[:20]), torch.from_numpy(xg[:20])
    via_gen = theads.predictive_scores(tcfg, tparams, tgen, h, xgt)
    via_sampler = theads.predictive_scores(tcfg, tparams, theads.Generator(), h, xgt,
                                           sampler=tsamplers.TreeSampler(tgen.tree))
    torch.testing.assert_close(via_gen, via_sampler, rtol=0, atol=0)


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) >= 12
    bad = [(str(p.relative_to(ROOT)), m) for p in files for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


@pytest.mark.parametrize("entry", ["init_head_params", "init_tree",
                                   "unigram_from_counts", "tree_from_numpy",
                                   "head_params_from_numpy", "train_linear_head",
                                   "fit_tree", "opt_state_from_numpy", "init_params",
                                   "init_cache", "default_head_state",
                                   "lm_params_from_numpy", "init_train_state"])
def test_card_default_raises_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "init_head_params": lambda: theads.init_head_params(torch.Generator(), 4, 3),
        "init_tree": lambda: ttree.init_tree(torch.Generator(), 4, 3),
        "unigram_from_counts": lambda: tsamplers.unigram_from_counts(np.ones(4)),
        "tree_from_numpy": lambda: convert.tree_from_numpy(
            np.zeros((3, 2)), np.zeros(3), np.arange(4), np.arange(4)),
        "head_params_from_numpy": lambda: convert.head_params_from_numpy(
            np.zeros((4, 3)), np.zeros(4)),
        "train_linear_head": lambda: txc.train_linear_head(
            theads.HeadConfig(num_labels=4, kind="uniform_ns"), theads.Generator(),
            np.zeros((8, 3)), np.zeros((8, 2)), np.zeros(8, np.int64), lr=0.1, steps=1),
        "fit_tree": lambda: tfit.fit_tree(np.zeros((8, 2)), np.arange(8) % 4, 4),
        "opt_state_from_numpy": lambda: convert.opt_state_from_numpy(
            0, (np.zeros((4, 3)), np.zeros(4))),
        "init_params": lambda: ttransformer.init_params(
            torch.Generator(), reduced_config("stablelm-3b")),
        "init_cache": lambda: ttransformer.init_cache(reduced_config("stablelm-3b"), 1, 4),
        "default_head_state": lambda: tlm_head.default_head_state(
            torch.Generator(), reduced_config("stablelm-3b"), "adversarial_ns"),
        "lm_params_from_numpy": lambda: convert.lm_params_from_numpy(
            {"embed": np.zeros((8, 4)), "layers": [], "final_norm": {"scale": np.zeros(4)},
             "head": {"w": np.zeros((8, 4)), "b": np.zeros(8)}}),
        "init_train_state": lambda: tstep.init_train_state(
            torch.Generator(), reduced_config("stablelm-3b"), OptimizerConfig(),
            "adversarial_ns"),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
