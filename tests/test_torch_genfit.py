"""The port's generator fitting (repro_torch.genfit) against the JAX package's
``repro.genfit``, and the reference's bit-exact claims as properties of the
port.

Inputs are made from a seed with numpy and given to both packages; the JAX
side runs its own jitted pieces, and a JAX-fitted tree crosses over with
``convert.tree_from_numpy``. Both packages draw every level's random start
from ``np.random.default_rng(seed)``, so a whole fit is compared, not only its
quality. Tolerances:
- the batched SPD inverse, one Newton start, Hessian factor and iteration,
  1e-4 relative: float32 sums and a 17-step Cholesky in two orders;
- whole fits, refits and refreshes: ``label_to_leaf`` equal, node
  parameters within 2e-3 (absolute plus relative), held-out log-likelihood
  within 1e-4: each level's Newton solve stops on host tests of float32
  values (a relative objective change of 1e-6), which two packages can pass
  one iteration apart.
The bit-exact claims of ``tests/test_genfit.py`` (a repeated fit, weighted ==
expanded partitions, zero-weight rows invisible, a repeated refit, sharded
serial == threaded) are held torch against torch, never torch against JAX.

The JAX side costs about 10 s of compilation per fit shape, so it fits three
shapes (C = 13 at N = 1024, C = 64 at N = 2000, and the C = 16 subtrees of
the drift refresh, which share the first shape's pieces).

The ``test_cuda_*`` tests need an NVIDIA card and skip elsewhere; they do not
import JAX. On a card, from the root of a checkout:
    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest -k cuda tests/test_torch_genfit.py
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro_torch import convert
from repro_torch.core import tree as ttree
from repro_torch.core.tree_fit import FitConfig, fit_tree, tree_log_likelihood
from repro_torch.genfit import (fit_tree_levelwise, fit_tree_sharded, label_counts,
                                refit_params, refresh_tree, subtree_drift)
from repro_torch.genfit import levels as tlevels
from repro_torch.genfit.incremental import perm_from_tree, real_leaf_mask
from repro_torch.kernels import ops
from repro_torch.parallel import round_robin_shard

CPU = "cpu"
PIECE_RTOL = 1e-4
PARAM_TOL = dict(atol=2e-3, rtol=2e-3)
LL_TOL = 1e-4
JAX_FITS = {13: 1024, 64: 2000}       # C -> N of the two JAX fit shapes


def _clustered(seed=0, n=3000, c=16, k=6, spread=3.0, n_held=1000, observed=None):
    """Labels live in feature clusters; optional cap on observed labels (the
    generator of ``tests/test_genfit.py``)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, k)) * spread
    y = rng.integers(0, observed or c, n)
    x = (centers[y] + rng.standard_normal((n, k))).astype(np.float32)
    yh = rng.integers(0, observed or c, n_held)
    xh = (centers[yh] + rng.standard_normal((n_held, k))).astype(np.float32)
    return x, y, xh, yh


def _drifted(x, seed=9):
    return x + 0.3 * np.random.default_rng(seed).standard_normal(x.shape).astype(np.float32)


def _carry(jtree, device=CPU):
    return convert.tree_from_numpy(*(np.asarray(a) for a in jtree), device=device)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same_tree(got, want):
    np.testing.assert_array_equal(_np(got.label_to_leaf), _np(want.label_to_leaf))
    np.testing.assert_array_equal(_np(got.leaf_to_label), _np(want.leaf_to_label))
    np.testing.assert_allclose(_np(got.w), _np(want.w), **PARAM_TOL)
    np.testing.assert_allclose(_np(got.b), _np(want.b), **PARAM_TOL)


def _assert_bit_equal(a, b):
    for name in ("w", "b", "label_to_leaf", "leaf_to_label"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()), name


def _check_invariants(tree, num_labels, x):
    """Leaf<->label bijection, real mass ~ 1, path == dense log-probs."""
    l2l = _np(tree.label_to_leaf)
    assert len(np.unique(l2l)) == num_labels
    np.testing.assert_array_equal(_np(tree.leaf_to_label)[l2l], np.arange(num_labels))
    xs = torch.as_tensor(x[:64], device=tree.w.device)
    np.testing.assert_allclose(_np(ttree.prob_mass_real(tree, xs)), 1.0, atol=1e-4)
    y = torch.arange(min(num_labels, 32), device=tree.w.device) % num_labels
    lp = ttree.log_prob(tree, xs[:len(y)], y)
    lp_all = ttree.log_prob_all(tree, xs[:len(y)])
    np.testing.assert_allclose(_np(lp), _np(lp_all.gather(1, y[:, None])[:, 0]),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's genfit, and its fits at the two compared shapes
    (imported only here: the card tests run where JAX is absent)."""
    import jax
    from repro.core.tree_fit import FitConfig as JaxFitConfig
    from repro.core.tree_fit import tree_log_likelihood as jax_ll
    from repro.genfit import incremental as jinc
    from repro.genfit import levels as jlevels

    fits = {}
    for c, n in JAX_FITS.items():
        x, y, xh, yh = _clustered(seed=c, c=c, n=n)
        fits[c] = dict(data=(x, y, xh, yh),
                       tree=jlevels.fit_tree_levelwise(x, y, c, config=JaxFitConfig(seed=0)))
    return dict(jax=jax, cfg=JaxFitConfig, ll=jax_ll, levels=jlevels, inc=jinc, fits=fits)


# ---------------------------------------------------------------------------
# Pieces and whole fits against the JAX package (CPU).
# ---------------------------------------------------------------------------

def test_batched_inv_psd_matches_jax(jax_side):
    rng = np.random.default_rng(0)
    m = rng.standard_normal((50, 17, 30)).astype(np.float32)
    a = (m @ m.transpose(0, 2, 1) / 30 + 0.2 * np.eye(17)).astype(np.float32)
    want = np.asarray(jax_side["jax"].jit(jax_side["levels"].batched_inv_psd)(a))
    got = tlevels.batched_inv_psd(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=PIECE_RTOL, atol=PIECE_RTOL * np.abs(want).max())
    np.testing.assert_allclose(got @ a, np.broadcast_to(np.eye(17), a.shape), atol=1e-3)


def test_newton_pieces_match_jax(jax_side):
    """One newton_start, refactor and newton_iter on the same inputs."""
    jlevels = jax_side["levels"]
    rng = np.random.default_rng(1)
    n, nseg, k, reg, tol = 600, 4, 6, 0.1, 1e-5
    d = k + 1
    x = rng.standard_normal((n, k)).astype(np.float32)
    xb = np.concatenate([x, np.ones((n, 1), np.float32)], 1)
    outer = (xb[:, :, None] * xb[:, None, :]).reshape(n, d * d)
    seg = rng.integers(0, nseg, n)
    zeta = np.where(x[:, 0] + 0.3 * rng.standard_normal(n) > 0, 1.0, -1.0).astype(np.float32)
    wgt = rng.uniform(0.5, 2.0, n).astype(np.float32)
    theta = (0.1 * rng.standard_normal((nseg, d))).astype(np.float32)
    frozen = np.array([False, False, True, False])
    jstart, jrefactor, jiter = jlevels.make_newton_pieces(
        nseg, d, reg, 25, tol, jlevels._seg_sum_fn(False))
    tstart, trefactor, titer = tlevels.make_newton_pieces(nseg, d, reg, tol, CPU)
    seg32 = seg.astype(np.int32)
    jz, jobj, jact, _ = jstart(theta, xb, zeta, wgt, seg32, frozen)
    t = [torch.from_numpy(a) for a in (theta, xb, zeta, wgt, seg, frozen)]
    tz, tobj, tact, _ = tstart(*t)
    for got, want in ((tz, jz), (tobj, jobj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PIECE_RTOL, atol=1e-5)
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    jinv = jrefactor(jz, outer, zeta, wgt, seg32)
    tinv = trefactor(tz, torch.from_numpy(outer), t[2], t[3], t[4])
    np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=PIECE_RTOL,
                               atol=PIECE_RTOL * float(np.abs(np.asarray(jinv)).max()))
    jout = jiter(theta, jz, jobj, jact, jinv, xb, zeta, wgt, seg32)
    tout = titer(t[0], tz, tobj, tact, tinv, t[1], t[2], t[3], t[4])
    for got, want in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PIECE_RTOL, atol=1e-4)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))


def test_discrete_and_finalize_match_jax(jax_side):
    """One discrete step and one finalize of level 1 of the C = 13 fit's
    shape, from the same theta (the JAX pieces are the fit's cached ones)."""
    jlevels, cfg = jax_side["levels"], jax_side["cfg"](seed=0)
    x, y, _, _ = jax_side["fits"][13]["data"]
    n, c, c_pad, k, level = len(y), 13, 16, x.shape[1], 1
    jp = jlevels._get_pieces(n, c_pad, k, level, jlevels._cfg_key(cfg))
    tp = tlevels._LevelPieces(c_pad, k, level, FitConfig(seed=0), CPU)
    rng = np.random.default_rng(2)
    perm = rng.permutation(c_pad)
    slot = np.argsort(perm)
    wgt = np.ones(n, np.float32)
    xb = np.concatenate([x, np.ones((n, 1), np.float32)], 1)
    theta = rng.standard_normal((2, k + 1)).astype(np.float32)
    i32 = lambda a: np.asarray(a, np.int32)                           # noqa: E731
    jaux = jp.prep(i32(y), wgt, i32(perm), i32(slot), np.int32(c))
    taux = tp.prep(torch.from_numpy(y), torch.from_numpy(wgt), torch.from_numpy(perm),
                   torch.from_numpy(slot), c)
    for name in ("node_of_point", "is_pad_slot", "n_real", "trivial", "split0"):
        np.testing.assert_array_equal(taux[name].numpy(), np.asarray(jaux[name]), err_msg=name)
    jd = jp.discrete(theta, jaux["split0"], jaux["split0"], jaux["trivial"], xb, i32(y), wgt,
                     i32(perm), i32(slot), jaux["node_of_point"], jaux["is_pad_slot"])
    td = tp.discrete(torch.from_numpy(theta), taux["split0"], taux["split0"], taux["trivial"],
                     torch.from_numpy(xb), torch.from_numpy(y), torch.from_numpy(wgt),
                     torch.from_numpy(perm), torch.from_numpy(slot), taux["node_of_point"],
                     taux["is_pad_slot"])
    for got, want in zip(td, jd):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jf = jp.finalize(theta, jd[0], i32(perm), jaux["is_pad_slot"], jaux["n_real"])
    tf = tp.finalize(torch.from_numpy(theta), td[0], torch.from_numpy(perm), taux["is_pad_slot"],
                     taux["n_real"])
    np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf[0]))
    for got, want in zip(tf[1:], jf[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("c", sorted(JAX_FITS))
def test_levelwise_fit_matches_jax(jax_side, c):
    fit = jax_side["fits"][c]
    x, y, xh, yh = fit["data"]
    got = fit_tree_levelwise(x, y, c, config=FitConfig(seed=0), device=CPU)
    _assert_same_tree(got, fit["tree"])
    ll = tree_log_likelihood(got, xh, yh)
    assert abs(ll - jax_side["ll"](fit["tree"], xh, yh)) <= LL_TOL
    assert ll > -np.log(c) + 0.5


def test_refit_params_matches_jax(jax_side):
    fit = jax_side["fits"][64]
    x, y, xh, yh = fit["data"]
    x2 = _drifted(x)
    want = jax_side["inc"].refit_params(fit["tree"], x2, y, 64, config=jax_side["cfg"](seed=0))
    got = refit_params(_carry(fit["tree"]), x2, y, 64, config=FitConfig(seed=0), device=CPU)
    _assert_same_tree(got, want)
    assert abs(tree_log_likelihood(got, xh, yh) - jax_side["ll"](want, xh, yh)) <= LL_TOL


def test_refresh_tree_with_drift_matches_jax(jax_side):
    """Labels 32.. lose their weight: the subtrees holding them drift, and
    both packages refit the same subtrees to the same tree."""
    fit = jax_side["fits"][64]
    x, y, xh, yh = fit["data"]
    wgt = (y < 32).astype(np.float32)
    kw = dict(sample_weight=wgt, prev_counts=label_counts(y, 64), drift_threshold=0.1,
              split_depth=2)
    want, want_counts = jax_side["inc"].refresh_tree(fit["tree"], x, y, 64,
                                                     config=jax_side["cfg"](seed=0), **kw)
    got, counts = refresh_tree(_carry(fit["tree"]), x, y, 64, config=FitConfig(seed=0),
                               device=CPU, **kw)
    assert subtree_drift(kw["prev_counts"], counts, got, 2).max() > 0.1
    np.testing.assert_array_equal(counts, want_counts)
    _assert_same_tree(got, want)
    _check_invariants(got, 64, x)


# ---------------------------------------------------------------------------
# The reference's properties, torch against torch (CPU).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [13, 64])
def test_heldout_ll_matches_sequential_oracle(c):
    """Level-parallel against the sequential oracle: held-out log-likelihood
    within 5% (both are local optima from different inits), and both clearly
    beat uniform."""
    x, y, xh, yh = _clustered(seed=c, c=c, n=4000)
    cfg = FitConfig(seed=0)
    ll_seq = tree_log_likelihood(fit_tree(x, y, c, config=cfg, device=CPU), xh, yh)
    ll_lvl = tree_log_likelihood(fit_tree_levelwise(x, y, c, config=cfg, device=CPU), xh, yh)
    assert ll_lvl > -np.log(c) + 0.5
    assert abs(ll_lvl - ll_seq) <= 0.05 * abs(ll_seq) + 0.02, (ll_lvl, ll_seq)


def test_weighted_matches_expanded():
    rng = np.random.default_rng(3)
    x_u = rng.standard_normal((40, 4)).astype(np.float32)
    y_u = rng.integers(0, 8, 40)
    w = rng.integers(1, 4, 40)
    cfg = FitConfig(seed=5)
    t_w = fit_tree_levelwise(x_u, y_u, 8, sample_weight=w.astype(np.float64), config=cfg,
                             device=CPU)
    t_e = fit_tree_levelwise(np.repeat(x_u, w, axis=0), np.repeat(y_u, w, axis=0), 8,
                             config=cfg, device=CPU)
    np.testing.assert_allclose(t_w.w.numpy(), t_e.w.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(t_w.label_to_leaf.numpy(), t_e.label_to_leaf.numpy())


def test_zero_weight_points_are_invisible():
    x, y, _, _ = _clustered(seed=1, c=16, n=1500)
    cfg = FitConfig(seed=0)
    t0 = fit_tree_levelwise(x, y, 16, config=cfg, device=CPU)
    x2 = np.concatenate([x, np.zeros((64, x.shape[1]), np.float32)])
    y2 = np.concatenate([y, np.zeros(64, y.dtype)])
    w2 = np.concatenate([np.ones(len(y), np.float32), np.zeros(64, np.float32)])
    t1 = fit_tree_levelwise(x2, y2, 16, sample_weight=w2, config=cfg, device=CPU)
    _assert_bit_equal(t0, t1)


def test_fit_is_deterministic():
    x, y, _, _ = _clustered(seed=2, c=32, n=2000)
    cfg = FitConfig(seed=7)
    _assert_bit_equal(fit_tree_levelwise(x, y, 32, config=cfg, device=CPU),
                      fit_tree_levelwise(x, y, 32, config=cfg, device=CPU))


def test_unobserved_labels_and_padding():
    x, y, _, _ = _clustered(seed=4, c=13, n=900, observed=11)
    t = fit_tree_levelwise(x, y, 13, config=FitConfig(seed=1), device=CPU)
    _check_invariants(t, 13, x)
    ids, _ = ttree.sample(t, torch.from_numpy(x[:2000]), generator=torch.Generator().manual_seed(0))
    assert int(ids.max()) < 13


@settings(max_examples=10, deadline=None)
@given(c=st.integers(2, 40), k=st.integers(1, 8), seed=st.integers(0, 2 ** 20))
def test_property_levelwise_invariants(c, k, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, k)) * 2.0
    y = rng.integers(0, c, 300)
    x = (centers[y] + rng.standard_normal((300, k))).astype(np.float32)
    _check_invariants(fit_tree_levelwise(x, y, c, config=FitConfig(seed=seed % 17), device=CPU),
                      c, x)


def test_segment_sums_go_through_ops(monkeypatch):
    """Every float sum over points of a fit calls ``ops.segment_stats``."""
    calls = []
    real = ops.segment_stats

    def counting(vals, seg, num_segments, plan=None):
        calls.append((vals.shape[1], num_segments))
        return real(vals, seg, num_segments, plan=plan)

    monkeypatch.setattr(ops, "segment_stats", counting)
    x, y, _, _ = _clustered(seed=3, c=16, n=600, k=4)
    fit_tree_levelwise(x, y, 16, config=FitConfig(seed=0), device=CPU)
    widths = {d for d, _ in calls}
    assert {1, 4, 5, 10, 25} <= widths, widths       # objective, s_lab, grad, Armijo, Hessian
    assert (1, 16) in calls                          # the discrete step's Δ over labels


def test_refit_preserves_structure_and_recovers_ll():
    x, y, _, _ = _clustered(seed=0, c=32, n=4000, k=8)
    cfg = FitConfig(seed=0)
    t0 = fit_tree_levelwise(x, y, 32, config=cfg, device=CPU)
    x2 = _drifted(x)
    t1 = refit_params(t0, x2, y, 32, config=cfg, device=CPU)
    np.testing.assert_array_equal(t1.label_to_leaf.numpy(), t0.label_to_leaf.numpy())
    _check_invariants(t1, 32, x2)
    ll_warm = tree_log_likelihood(t1, x2, y)
    ll_cold = tree_log_likelihood(fit_tree_levelwise(x2, y, 32, config=cfg, device=CPU), x2, y)
    assert ll_warm >= tree_log_likelihood(t0, x2, y) - 1e-6
    assert ll_warm > ll_cold - 0.1 * abs(ll_cold), (ll_warm, ll_cold)


def test_refit_is_deterministic():
    x, y, _, _ = _clustered(seed=1, c=16, n=1200)
    cfg = FitConfig(seed=0)
    t0 = fit_tree_levelwise(x, y, 16, config=cfg, device=CPU)
    _assert_bit_equal(refit_params(t0, x, y, 16, config=cfg, device=CPU),
                      refit_params(t0, x, y, 16, config=cfg, device=CPU))


def test_drift_detection_and_subtree_refresh():
    x, y, _, _ = _clustered(seed=5, c=32, n=4000, k=8)
    cfg = FitConfig(seed=0)
    t0 = fit_tree_levelwise(x, y, 32, config=cfg, device=CPU)
    cnt0 = label_counts(y, 32)
    keep = y < 16
    x2, y2 = x[keep], y[keep]
    assert subtree_drift(cnt0, label_counts(y2, 32), t0, split_depth=2).max() > 0.1
    t1, cnt1 = refresh_tree(t0, x2, y2, 32, config=cfg, prev_counts=cnt0, drift_threshold=0.1,
                            split_depth=2, device=CPU)
    _check_invariants(t1, 32, x2)
    np.testing.assert_allclose(cnt1, label_counts(y2, 32))


def test_perm_roundtrip():
    x, y, _, _ = _clustered(seed=6, c=13, n=600)
    t = fit_tree_levelwise(x, y, 13, config=FitConfig(seed=2), device=CPU)
    perm = perm_from_tree(t, 13)
    assert sorted(perm.tolist()) == list(range(16))
    real = real_leaf_mask(t, 13)
    assert int(real.sum()) == 13
    np.testing.assert_array_equal(perm[real], t.leaf_to_label.numpy()[real])


def test_sharded_serial_equals_threaded():
    x, y, xh, yh = _clustered(seed=0, c=64, n=6000, k=8)
    cfg = FitConfig(seed=0)
    t_serial = fit_tree_sharded(x, y, 64, config=cfg, split_depth=2, device=CPU)
    with ThreadPoolExecutor(2) as ex:
        t_thread = fit_tree_sharded(x, y, 64, config=cfg, split_depth=2, executor=ex,
                                    device=CPU)
    _assert_bit_equal(t_serial, t_thread)
    _check_invariants(t_serial, 64, x)
    ll_lvl = tree_log_likelihood(fit_tree_levelwise(x, y, 64, config=cfg, device=CPU), xh, yh)
    assert abs(tree_log_likelihood(t_serial, xh, yh) - ll_lvl) <= 0.1 * abs(ll_lvl) + 0.02


def test_sharded_split_depth_edges():
    x, y, _, _ = _clustered(seed=2, c=8, n=500, k=4)
    cfg = FitConfig(seed=0)
    _assert_bit_equal(fit_tree_sharded(x, y, 8, config=cfg, split_depth=10, device=CPU),
                      fit_tree_levelwise(x, y, 8, config=cfg, device=CPU))
    _check_invariants(fit_tree_sharded(x, y, 8, config=cfg, split_depth=0, device=CPU), 8, x)


def test_sharded_parts_cover_the_tree():
    """Two shards' partial arrays hold disjoint subtrees whose union is the
    single-shard fit."""
    x, y, _, _ = _clustered(seed=3, c=32, n=2000, k=4)
    cfg = FitConfig(seed=0)
    whole = fit_tree_sharded(x, y, 32, config=cfg, split_depth=2, _return_parts=True,
                             device=CPU)
    parts = [fit_tree_sharded(x, y, 32, config=cfg, split_depth=2, shard_index=i,
                              shard_count=2, device=CPU) for i in range(2)]
    s_leaves = 32 >> 2
    for j in range(4):
        mine = parts[j % 2]
        np.testing.assert_array_equal(mine[2][j * s_leaves:(j + 1) * s_leaves],
                                      whole[2][j * s_leaves:(j + 1) * s_leaves])


def test_round_robin_shard():
    items = sorted(round_robin_shard(10, 0, 3) + round_robin_shard(10, 1, 3)
                   + round_robin_shard(10, 2, 3))
    assert items == list(range(10))
    assert round_robin_shard(5) == list(range(5))       # no process group: shard 0 of 1
    with pytest.raises(ValueError):
        round_robin_shard(5, 3, 3)


@pytest.mark.parametrize("entry", ["fit_tree_levelwise", "refit_params", "refresh_tree",
                                   "fit_tree_sharded"])
def test_card_default_raises_without_cuda(monkeypatch, entry):
    x, y, _, _ = _clustered(seed=0, c=4, n=50, k=2)
    tree = fit_tree_levelwise(x, y, 4, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "fit_tree_levelwise": lambda: fit_tree_levelwise(x, y, 4),
        "refit_params": lambda: refit_params(tree, x, y, 4),
        "refresh_tree": lambda: refresh_tree(tree, x, y, 4),
        "fit_tree_sharded": lambda: fit_tree_sharded(x, y, 4),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


# ---------------------------------------------------------------------------
# On a card: the fit through the kernel, its replay, and its agreement with
# the CPU run.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def test_cuda_fit_matches_cpu_and_replays(cuda):
    x, y, xh, yh = _clustered(seed=64, c=64, n=4000)
    cfg = FitConfig(seed=0)
    before = ops.segment_stats.launches
    card = fit_tree_levelwise(x, y, 64, config=cfg, device=cuda)
    assert ops.segment_stats.launches > before
    _assert_bit_equal(card, fit_tree_levelwise(x, y, 64, config=cfg, device=cuda))
    _assert_same_tree(card, fit_tree_levelwise(x, y, 64, config=cfg, device=CPU))
    _check_invariants(card, 64, x)


def test_cuda_refit_and_sharded_replay(cuda):
    x, y, _, _ = _clustered(seed=0, c=64, n=6000, k=8)
    cfg = FitConfig(seed=0)
    tree = fit_tree_levelwise(x, y, 64, config=cfg, device=cuda)
    x2 = _drifted(x)
    _assert_bit_equal(refit_params(tree, x2, y, 64, config=cfg, device=cuda),
                      refit_params(tree, x2, y, 64, config=cfg, device=cuda))
    serial = fit_tree_sharded(x, y, 64, config=cfg, split_depth=2, device=cuda)
    with ThreadPoolExecutor(2) as ex:
        threaded = fit_tree_sharded(x, y, 64, config=cfg, split_depth=2, executor=ex,
                                    device=cuda)
    _assert_bit_equal(serial, threaded)


def test_cuda_zero_weight_points_are_invisible(cuda):
    x, y, _, _ = _clustered(seed=1, c=16, n=1500)
    cfg = FitConfig(seed=0)
    t0 = fit_tree_levelwise(x, y, 16, config=cfg, device=cuda)
    x2 = np.concatenate([x, np.zeros((64, x.shape[1]), np.float32)])
    y2 = np.concatenate([y, np.zeros(64, y.dtype)])
    w2 = np.concatenate([np.ones(len(y), np.float32), np.zeros(64, np.float32)])
    _assert_bit_equal(t0, fit_tree_levelwise(x2, y2, 16, sample_weight=w2, config=cfg,
                                             device=cuda))
