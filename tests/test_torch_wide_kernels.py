"""The two kernels at the widths of gemma2-27b and mixtral-8x22b, past the
old fixed limits (K <= 4,096 for ``sampled_head_loss``, k <= 32 for
``tree_logprob_all``).

The plain versions that the port's wrappers take on the CPU are held to the
JAX package's plain references (``repro.kernels.ref``, jit-compiled on the
CPU; the Pallas kernels cannot run on the installed JAX): the sampled loss
at K = 4,608 (gemma2-27b's d) and 6,144 (mixtral-8x22b's) for every kind,
both table dtypes, m = 2 and 17 (17: the kernel's chunked staging on the
card); the dense tree log-probs at k = 33, 48 and 64 (ragged and whole
32-feature chunks). On fake tensors (the dry run's stand-in card) both
wrappers take the two families' widths and report one launch each with
their module's FLOP and byte formula; past each kernel's limit, now derived
from its shared memory, they raise and name it.

Tolerances: float32 sums of up to 6,144 products in another order, 1e-5
absolute + 1e-5 relative for losses, coefficients, scores and dh (inputs
scaled so scores stay O(1)); the tree's 10-level sums of log-sigmoids,
1e-4 absolute + 1e-5 relative, as the port's other tree tests.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import device as device_lib
from repro_torch.kernels import ops
from repro_torch.kernels import sampled_loss as sl
from repro_torch.kernels import tree_logprob as tlp
from repro_torch.kernels.sampled_loss import SAMPLED_KINDS

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
TREE_TOL = dict(atol=1e-4, rtol=1e-5)
T, C = 16, 3000
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


LOSS_KW = dict(num_labels=C, reg=1e-2, softcap=25.0, mask_accidental=True)


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    @functools.lru_cache(maxsize=None)
    def all_kinds(kdim, m, dtype):
        """The JAX reference of every kind on one input, in one jit."""
        w, b, h, ids, lp = _head_inputs(kdim + m, kdim, m)
        jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
        fn = jax.jit(lambda *a: [jref.sampled_head_loss_ref(*a, kind=kind, **LOSS_KW)
                                 for kind in SAMPLED_KINDS])
        out = fn(jnp.asarray(w, jdtype), jnp.asarray(b, jdtype), jnp.asarray(h),
                 jnp.asarray(ids.astype(np.int32)), jnp.asarray(lp))
        return {kind: [np.asarray(x) for x in o] for kind, o in zip(SAMPLED_KINDS, out)}

    return dict(jnp=jnp, all_kinds=all_kinds, tree=jax.jit(jref.tree_logprob_all_ref))


def _head_inputs(seed, kdim, m):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((C, kdim)) / np.sqrt(kdim)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    h = rng.standard_normal((T, kdim)).astype(np.float32)
    ids = rng.integers(0, C, (T, m))
    ids[::3, 1] = ids[::3, 0]              # accidental hits on every third token
    lp = (-np.abs(rng.standard_normal((T, m))) - 2.0).astype(np.float32)
    return w, b, h, ids, lp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [2, 17])
@pytest.mark.parametrize("kdim", [4608, 6144])
@pytest.mark.parametrize("kind", SAMPLED_KINDS)
def test_wide_sampled_head_loss_matches_jax(jax_side, kind, kdim, m, dtype):
    w, b, h, ids, lp = _head_inputs(kdim + m, kdim, m)
    tw, tb = torch.from_numpy(w).to(DTYPES[dtype]), torch.from_numpy(b).to(DTYPES[dtype])
    got = ops.sampled_head_loss(tw, tb, torch.from_numpy(h), torch.from_numpy(ids),
                                torch.from_numpy(lp), kind=kind, **LOSS_KW)
    want = jax_side["all_kinds"](kdim, m, dtype)[kind]
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w_, **LOSS_TOL)


@pytest.mark.parametrize("k", [33, 48, 64])
def test_wide_tree_logprob_all_matches_jax(jax_side, k):
    jnp = jax_side["jnp"]
    depth, bsz = 10, 5
    rng = np.random.default_rng(k)
    w = (rng.standard_normal(((1 << depth) - 1, k)) / np.sqrt(k)).astype(np.float32)
    b = (0.3 * rng.standard_normal((1 << depth) - 1)).astype(np.float32)
    x = rng.standard_normal((bsz, k)).astype(np.float32)
    got = ops.tree_logprob_all(torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(x))
    want = jax_side["tree"](jnp.asarray(w), jnp.asarray(b), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TREE_TOL)
    assert got.shape == (bsz, 1 << depth)


# ---------------------------------------------------------------------------
# The wrappers on fake tensors: what the dry run and the card take.
# ---------------------------------------------------------------------------

def _fake_calls(fn):
    """Run ``fn`` under the dry run's fake tensors and stand-in card; return
    its (kernel, flops, bytes) records."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    calls = []
    card = device_lib.FakeCard("NVIDIA H100 80GB HBM3", 132,
                               lambda *r: calls.append(r))
    with FakeTensorMode(), device_lib.fake_card(card):
        fn()
    return calls


FAMILIES = {"gemma2-27b": tconfigs.get_config("gemma2-27b"),
            "mixtral-8x22b": tconfigs.get_config("mixtral-8x22b")}


@pytest.mark.parametrize("table", DTYPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_sampled_head_loss_takes_the_families_width(arch, table):
    cfg = FAMILIES[arch]
    t, m, k, c = 4096, 2, cfg.d_model, cfg.vocab_size

    def call():
        w = torch.empty((c, k), dtype=DTYPES[table])
        b = torch.empty((c,), dtype=DTYPES[table])
        out = ops.sampled_head_loss(w, b, torch.empty((t, k)),
                                    torch.empty((t, m), dtype=torch.int64),
                                    torch.empty((t, m)), kind="adversarial_ns",
                                    num_labels=c)
        assert [tuple(o.shape) for o in out] == [(t,), (t, m), (t, m), (t, k)]

    itemsize = 4 if table == "f32" else 2
    assert _fake_calls(call) == [("sampled_head_loss",
                                  *sl.cost(t, m, k, itemsize, min(t * m, c)))]


@pytest.mark.parametrize("arch", FAMILIES)
def test_tree_logprob_all_takes_the_families_width(arch):
    cfg = FAMILIES[arch]
    k, bsz = cfg.gen_feature_dim, 4
    depth = (cfg.vocab_size - 1).bit_length()
    n_nodes = (1 << depth) - 1

    def call():
        out = ops.tree_logprob_all(torch.empty((n_nodes, k)), torch.empty((n_nodes,)),
                                   torch.empty((bsz, k)))
        assert tuple(out.shape) == (bsz, 1 << depth)

    assert _fake_calls(call) == [("tree_logprob_all", *tlp.cost(bsz, n_nodes, k))]
    assert k <= tlp.largest_k(depth, tlp.TENSOR_CORES)


@pytest.mark.parametrize("m,itemsize", [(2, 4), (17, 4), (512, 4), (2, 2), (17, 2), (512, 2)])
def test_sampled_head_loss_past_its_limit_raises_and_names_it(m, itemsize):
    limit = sl.max_k(m, itemsize)
    assert limit >= 27_000 if itemsize == 4 else limit >= 36_000
    assert sl._smem_bytes(1, m, limit, itemsize) <= sl._MAX_SMEM_BYTES
    assert sl._smem_bytes(1, m, limit + 1, itemsize) > sl._MAX_SMEM_BYTES
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16

    def call(k):
        def fn():
            ops.sampled_head_loss(torch.empty((10, k), dtype=dtype), torch.empty((10,), dtype=dtype),
                                  torch.empty((4, k)), torch.empty((4, m), dtype=torch.int64),
                                  torch.empty((4, m)), kind="nce", num_labels=10)
        return fn

    assert len(_fake_calls(call(limit))) == 1
    with pytest.raises(ValueError, match=f"K <= {limit} "):
        _fake_calls(call(limit + 1))


@pytest.mark.parametrize("depth", [5, 7, 10, 18, 30])
def test_tree_logprob_all_past_its_limit_raises_and_names_it(depth):
    kernel = tlp.FMA if depth < tlp.TENSOR_CORE_MIN_DEPTH else tlp.TENSOR_CORES
    limit = tlp.largest_k(depth, kernel)
    assert limit >= 128
    n_nodes = (1 << depth) - 1

    def call(k):
        def fn():
            ops.tree_logprob_all(torch.empty((n_nodes, k)), torch.empty((n_nodes,)),
                                 torch.empty((4, k)))
        return fn

    assert len(_fake_calls(call(limit))) == 1
    with pytest.raises(ValueError, match=f"k <= {limit} at depth {depth}"):
        _fake_calls(call(limit + 1))


@pytest.mark.parametrize("m,k,itemsize,want", [
    (17, 6144, 4, 8),        # mixtral's K, float32: three chunks (8, 8, 1)
    (17, 6144, 2, 16),       # bf16 rows: two chunks (16, 1)
    (2, 6144, 4, 2),
    (17, 4608, 4, 11),       # gemma2-27b's K, float32: two chunks
    (2, 4608, 4, 2),
])
def test_staged_slots_at_the_new_widths_fit_the_entrys_check(m, k, itemsize, want):
    """The chunk the wrapper hands the C entry passes its ``smem_bytes``
    check (the same arithmetic), and one more slot would not."""
    chunk = sl.staged_slots(m, k, itemsize)
    assert chunk == want
    assert sl._smem_bytes(chunk, m, k, itemsize) <= sl._MAX_SMEM_BYTES
    assert chunk == m or sl._smem_bytes(chunk + 1, m, k, itemsize) > sl._MAX_SMEM_BYTES


@pytest.mark.parametrize("k", [16, 32, 33, 48, 64, 96, 128, 200])
@pytest.mark.parametrize("bsz,depth", [(4, 18), (256, 18), (4, 15), (1, 30)])
def test_tree_launch_plan_stages_what_fits(bsz, depth, k):
    """The plan's sub-blocks are the most whose staging fits a block (16 up
    to k = 64), then halved only for the grid."""
    kernel, groups, sub = tlp.launch_plan(bsz, depth, 132, k)
    assert kernel == tlp.TENSOR_CORES
    assert tlp.tc_smem_bytes(depth, k, sub) <= tlp._MAX_SMEM_BYTES
    fits16 = tlp.tc_smem_bytes(depth, k, 16) <= tlp._MAX_SMEM_BYTES
    assert fits16 == (k <= 64)
    if not fits16:
        assert tlp.tc_smem_bytes(depth, k, 2 * sub) > tlp._MAX_SMEM_BYTES


def test_fma_kernel_stages_sixty_four_features_at_depth_seven():
    assert tlp.fma_smem_bytes(7, 64) <= tlp._MAX_SMEM_BYTES
    assert tlp.launch_plan(4, 7, 132, 64) == (tlp.FMA, 0, 0)
