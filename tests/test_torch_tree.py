"""The port's tree (repro_torch.core.tree) against the JAX package's
(repro.core.tree), on the same numpy weights, on the CPU.

Tolerance: 1e-4 absolute, 1e-5 relative, for log-probs summed over the
tree's depth levels in float32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tree as jtree
from repro_torch import convert
from repro_torch.core import tree as ttree

TOL = dict(atol=1e-4, rtol=1e-5)
K = 6


@functools.lru_cache(maxsize=None)
def _trees(c, seed=0, scale=0.9):
    """A JAX tree and the same tree in the port: random numpy weights,
    padding forced by the JAX package, and a shuffled label<->leaf
    bijection so that leaf order != label order."""
    rng = np.random.default_rng(seed)
    c_pad = jtree.padded_size(c)
    w = (scale * rng.standard_normal((c_pad - 1, K))).astype(np.float32)
    b = (0.2 * rng.standard_normal(c_pad - 1)).astype(np.float32)
    b = np.asarray(jtree._force_padding(b, c, c_pad))
    label_to_leaf = rng.permutation(c).astype(np.int32)   # real leaves stay < c
    leaf_to_label = np.zeros(c_pad, np.int32)
    leaf_to_label[label_to_leaf] = np.arange(c)
    arrays = (w, b, label_to_leaf, leaf_to_label)
    jt = jtree.Tree(*(jnp.asarray(a) for a in arrays))
    return jt, convert.tree_from_numpy(*arrays, device="cpu")


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape + (K,)).astype(np.float32)


@pytest.mark.parametrize("c", [5, 64, 100])
def test_log_prob_matches_jax(c):
    jt, tt = _trees(c)
    x = _x(1, 3, 4)
    y = np.random.default_rng(2).integers(0, c, (3, 4))
    want = jax.jit(jtree.log_prob)(jt, jnp.asarray(x), jnp.asarray(y, jnp.int32))
    got = ttree.log_prob(tt, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("c", [2, 5, 100])
def test_log_prob_all_matches_jax(c):
    jt, tt = _trees(c)
    x = _x(3, 2, 5)
    want = jax.jit(jtree.log_prob_all)(jt, jnp.asarray(x))
    got = ttree.log_prob_all(tt, torch.from_numpy(x))
    assert got.shape == (2, 5, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("c,beam,topk", [
    (100, 8, 4),       # narrow beam
    (100, 4, 7),       # topk > beam: padded with label -1, -inf
    (64, 64, 64),      # exhaustive beam, every label
    (5, 8, 5),         # beam wider than C: padding leaves masked out
    (37, 512, 10),     # beam clipped to C_pad
])
def test_beam_search_matches_jax(c, beam, topk):
    jt, tt = _trees(c, seed=c, scale=1.3)
    x = _x(4, 9)
    fn = jax.jit(functools.partial(jtree.beam_search, beam=beam, topk=topk))
    want_labels, want_logp = (np.asarray(a) for a in fn(jt, jnp.asarray(x)))
    labels, logp = ttree.beam_search(tt, torch.from_numpy(x), beam, topk)
    assert labels.shape == logp.shape == (9, topk)
    np.testing.assert_array_equal(labels.numpy(), want_labels)
    np.testing.assert_allclose(logp.numpy(), want_logp, **TOL)
    dead = labels.numpy() < 0
    assert np.isneginf(logp.numpy()[dead]).all()
    assert np.isfinite(logp.numpy()[~dead]).all()


def test_beam_search_rejects_empty_beam():
    _, tt = _trees(10)
    with pytest.raises(ValueError):
        ttree.beam_search(tt, torch.zeros(2, K), 0, 1)


@pytest.mark.parametrize("c", [3, 100])
def test_prob_mass_real_is_one_and_matches_jax(c):
    jt, tt = _trees(c)
    x = _x(5, 6)
    got = ttree.prob_mass_real(tt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, 1.0, atol=1e-5)
    want = jax.jit(jtree.prob_mass_real)(jt, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_validate_accepts_a_tree_and_rejects_a_broken_bijection():
    jt, tt = _trees(20)
    assert ttree.validate(tt, 20) is tt
    jtree.validate(jt, 20)
    l2l = tt.label_to_leaf.clone()
    l2l[0] = l2l[1]
    with pytest.raises(ValueError, match="injective"):
        ttree.validate(tt._replace(label_to_leaf=l2l), 20)
    swapped = tt.leaf_to_label.clone()
    swapped[tt.label_to_leaf[0]] = 1
    with pytest.raises(ValueError, match="invert"):
        ttree.validate(tt._replace(leaf_to_label=swapped), 20)
    with pytest.raises(ValueError, match="shape"):
        ttree.validate(tt, 21)


@pytest.mark.parametrize("c", [3, 100, 257])
def test_init_tree_padding_equals_jax(c):
    jt = jtree.init_tree(jax.random.PRNGKey(0), c, K)
    tt = ttree.init_tree(torch.Generator().manual_seed(0), c, K, device="cpu")
    assert tt.depth == jt.depth and tt.num_labels == c and tt.feature_dim == K
    np.testing.assert_array_equal(tt.b.numpy() == -ttree.PAD_LOGIT,
                                  np.asarray(jt.b) == -jtree.PAD_LOGIT)
    np.testing.assert_array_equal(tt.b.numpy(), np.asarray(jt.b))
    np.testing.assert_array_equal(tt.label_to_leaf.numpy(), np.asarray(jt.label_to_leaf))
    np.testing.assert_array_equal(tt.leaf_to_label.numpy(), np.asarray(jt.leaf_to_label))
    ttree.validate(tt, c)


def test_force_padding_equals_the_jax_loop_at_many_sizes():
    for c in list(range(1, 70)) + [1000, 4097]:
        c_pad = jtree.padded_size(c)
        b = np.random.default_rng(c).standard_normal(c_pad - 1).astype(np.float32)
        want = np.asarray(jtree._force_padding(jnp.asarray(b), c, c_pad))
        got = ttree._force_padding(torch.from_numpy(b), c, c_pad).numpy()
        np.testing.assert_array_equal(got, want)


def test_padded_size_equals_jax():
    for c in list(range(1, 300)) + [217_240]:
        assert ttree.padded_size(c) == jtree.padded_size(c)


def test_sample_with_jax_uniforms_matches_jax():
    c = 100
    jt, tt = _trees(c, scale=1.5)
    x = _x(6, 64)
    rng = jax.random.PRNGKey(7)
    want_labels, want_logp = jax.jit(jtree.sample)(jt, jnp.asarray(x), rng)
    u = jax.random.uniform(rng, (64, jt.depth), jnp.float32)
    labels, logp = ttree.sample(tt, torch.from_numpy(x), u=torch.from_numpy(np.array(u)))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    np.testing.assert_allclose(logp.numpy(), np.asarray(want_logp), **TOL)
    # The walk's log-prob is log_prob of the label it reached.
    np.testing.assert_allclose(
        logp.numpy(), ttree.log_prob(tt, torch.from_numpy(x), labels).numpy(), **TOL)


def test_sample_from_a_generator_is_seeded_and_real():
    _, tt = _trees(13)
    x = torch.from_numpy(_x(8, 200))
    a = ttree.sample(tt, x, generator=torch.Generator().manual_seed(3))
    b = ttree.sample(tt, x, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert ((a[0] >= 0) & (a[0] < 13)).all()
    with pytest.raises(ValueError):
        ttree.sample(tt, x)
