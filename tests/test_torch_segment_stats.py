"""The port's ``segment_stats`` against the JAX package, and, on a card, its
CUDA kernel against its plain version.

On the CPU the port's wrapper takes the plain version (``index_add_``), which
is held against ``repro.kernels.ref.segment_stats_ref`` (``jax.ops.segment_sum``
under ``jax.jit``) and against the Pallas ``segment_stats`` in interpret mode.
Inputs are made from a seed with numpy. Both CPU sides add each segment's rows
in row order in float32, so they agree to rounding: 1e-6 absolute plus 1e-6 of
the segment's sum of |vals|.

On a card the kernel is held against the plain version (atomics, so another
order) within 1e-4 of the segment's sum of |vals|: float32 sums of up to
5e5 terms in two orders. Two calls on the same input must agree bit for bit.

The ``test_cuda_*`` tests need an NVIDIA card and skip elsewhere; they do not
import JAX. On a card, from the root of a checkout:
    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest -k cuda tests/test_torch_segment_stats.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref

CPU_TOL = 1e-6       # relative to the segment's sum of |vals|, plus the same absolute
CARD_TOL = 1e-4      # kernel against the card's plain version (atomic order)


@pytest.fixture(scope="module")
def jax_side():
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.segment_scores import segment_stats as pallas_segment_stats

    return dict(
        jnp=jnp,
        ref=jax.jit(jref.segment_stats_ref, static_argnums=2),
        pallas=lambda v, s, n: pallas_segment_stats(v, s, n, interpret=True))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, n, d, s, *, out_of_range=False, zipf=False):
    """vals (N, D) float32 and ids (N,) int64; ``out_of_range`` makes about a
    tenth of the ids negative or >= S, ``zipf`` draws ids from zipf(1.3)."""
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, d)).astype(np.float32)
    if zipf:
        p = np.arange(1, s + 1, dtype=np.float64) ** -1.3
        seg = rng.permutation(s)[rng.choice(s, size=n, p=p / p.sum())]
    else:
        seg = rng.integers(0, s, n)
    if out_of_range and n:
        bad = rng.random(n) < 0.1
        seg = np.where(bad, rng.choice([-3, -1, s, s + 7], size=n), seg)
    return vals, seg.astype(np.int64)


def _scale(vals, seg, s):
    """Each segment's sum of |vals|: the size of the terms its sum adds."""
    return tref.segment_stats_ref(vals.abs().float(), seg, s)


def _assert_close(got, want, scale, rel):
    err = (got.double() - want.double()).abs()
    bound = rel * (scale.double() + 1.0)
    assert bool((err <= bound).all()), float((err - bound).max())


SHAPES = [  # (N, D, S, out_of_range)
    (700, 17, 37, True),
    (0, 17, 5, False),
    (513, 1, 1, False),
    (300, 289, 4, True),
    (1000, 10, 64, False),
    (64, 3, 200, True),
]


@pytest.mark.parametrize("n,d,s,oob", SHAPES)
def test_plain_matches_jax_ref(jax_side, n, d, s, oob):
    jnp = jax_side["jnp"]
    vals, seg = _inputs(n + d + s, n, d, s, out_of_range=oob)
    want = np.array(jax_side["ref"](jnp.asarray(vals), jnp.asarray(seg, jnp.int32), s))
    tv, ts = torch.from_numpy(vals), torch.from_numpy(seg)
    got = ops.segment_stats(tv, ts, s)
    assert got.dtype == torch.float32 and got.shape == (s, d)
    _assert_close(got, torch.from_numpy(want), _scale(tv, ts, s), CPU_TOL)


@pytest.mark.parametrize("n,d,s", [(700, 17, 37), (513, 1, 1), (300, 289, 4)])
def test_plain_matches_pallas_interpret(jax_side, n, d, s):
    """The Pallas kernel takes ids in [0, S) and drops its own padding rows."""
    jnp = jax_side["jnp"]
    vals, seg = _inputs(n * 3 + d, n, d, s)
    want = np.array(jax_side["pallas"](jnp.asarray(vals), jnp.asarray(seg, jnp.int32), s))
    tv, ts = torch.from_numpy(vals), torch.from_numpy(seg)
    _assert_close(ops.segment_stats(tv, ts, s), torch.from_numpy(want),
                  _scale(tv, ts, s), CPU_TOL)


def test_plain_bf16_vals_match_jax_ref(jax_side):
    jnp = jax_side["jnp"]
    vals, seg = _inputs(3, 400, 17, 23, out_of_range=True)
    tv = torch.from_numpy(vals).bfloat16()
    want = np.array(jax_side["ref"](jnp.asarray(vals).astype(jnp.bfloat16),
                                      jnp.asarray(seg, jnp.int32), 23))
    ts = torch.from_numpy(seg)
    _assert_close(ops.segment_stats(tv, ts, 23), torch.from_numpy(want),
                  _scale(tv, ts, 23), CPU_TOL)


def test_cpu_tensors_take_the_plain_version():
    vals, seg = (torch.from_numpy(a) for a in _inputs(1, 90, 5, 7, out_of_range=True))
    before = ops.segment_stats.launches
    out = ops.segment_stats(vals, seg, 7)
    assert ops.segment_stats.launches == before
    torch.testing.assert_close(out, tref.segment_stats_ref(vals, seg, 7), rtol=0, atol=0)


def test_out_of_range_rows_are_dropped():
    vals = torch.ones((6, 2))
    seg = torch.tensor([0, -1, 2, 3, -7, 2])
    out = ops.segment_stats(vals, seg, 3)
    torch.testing.assert_close(out, torch.tensor([[1.0, 1.0], [0.0, 0.0], [2.0, 2.0]]))


def test_int32_ids_equal_int64_ids():
    vals, seg = (torch.from_numpy(a) for a in _inputs(2, 200, 4, 9, out_of_range=True))
    torch.testing.assert_close(ops.segment_stats(vals, seg.int(), 9),
                               ops.segment_stats(vals, seg, 9), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["float_ids", "ids_length", "vals_1d", "negative_s",
                                 "int16_ids"])
def test_rejects_what_the_kernel_does_not_take(bad):
    vals, seg = (torch.from_numpy(a) for a in _inputs(0, 20, 3, 4))
    s = 4
    if bad == "float_ids":
        seg = seg.float()
    elif bad == "ids_length":
        seg = seg[:5]
    elif bad == "vals_1d":
        vals = vals[:, 0]
    elif bad == "negative_s":
        s = -1
    else:
        seg = seg.to(torch.int16)
    with pytest.raises((TypeError, ValueError)):
        ops.segment_stats(vals, seg, s)


@pytest.mark.parametrize("n,d,s,oob", SHAPES)
def test_plan_gives_the_same_bits_on_the_plain_version(n, d, s, oob):
    """On the CPU a plan changes nothing: the plain version runs either way."""
    vals, seg = (torch.from_numpy(a) for a in _inputs(n + 2 * d + s, n, d, s, out_of_range=oob))
    before = ops.segment_stats.plans, ops.segment_stats.launches
    plan = ops.segment_plan(seg, s)
    assert (plan.n, plan.num_segments, plan.device) == (n, s, seg.device)
    assert plan.perm is None and plan.n_chunks == 0
    got = ops.segment_stats(vals, seg, s, plan=plan)
    assert (ops.segment_stats.plans, ops.segment_stats.launches) == before
    assert torch.equal(got, ops.segment_stats(vals, seg, s))


@pytest.mark.parametrize("bad", ["rows", "segments", "device"])
def test_plan_for_other_ids_is_refused(bad):
    vals, seg = (torch.from_numpy(a) for a in _inputs(4, 50, 3, 6))
    plan = ops.segment_plan(seg, 6)
    if bad == "rows":
        plan = ops.segment_plan(seg[:49], 6)
    elif bad == "segments":
        plan = ops.segment_plan(seg, 7)
    else:
        plan = dataclasses.replace(plan, device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="plan"):
        ops.segment_stats(vals, seg, 6, plan=plan)


def test_chunk_table_counts_chunks_from_each_segments_first_row():
    """The long segments' chunks: 256 rows each from the segment's own first
    sorted position, the last one ragged, listed in segment order."""
    from repro_torch.kernels.segment_scores import chunk_table
    off = torch.tensor([0, 3, 3, 600, 610, 1122, 1122], dtype=torch.int32)
    chunks, long_seg, long_first = chunk_table(off, 256)
    assert chunks.tolist() == [[3, 259], [259, 515], [515, 600], [610, 866], [866, 1122]]
    assert long_seg.tolist() == [2, 4] and long_first.tolist() == [0, 3, 5]
    assert all(t.dtype == torch.int32 for t in (chunks, long_seg, long_first))
    assert chunk_table(torch.tensor([0, 5, 261, 261], dtype=torch.int32), 256) == (
        None, None, None)


# ---------------------------------------------------------------------------
# On a card: the kernel against its plain version, and bit-exact replay.
# ---------------------------------------------------------------------------

CARD_SHAPES = [  # (N, D, S, out_of_range, zipf)
    (1, 1, 1, False, False),
    (700, 17, 37, True, False),
    (5000, 289, 1, False, False),
    (5000, 289, 4096, True, False),
    (5000, 289, 5000, False, False),
    (70_000, 17, 3, False, False),
    (70_000, 1, 65_536, True, True),
    (20_000, 10, 512, False, True),
    (3000, 700, 9, True, False),
    (3000, 40, 100, False, False),
    (2000, 100, 7, False, False),
]


@pytest.mark.parametrize("n,d,s,oob,zipf", CARD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(cuda, n, d, s, oob, zipf, dtype):
    vals, seg = _inputs(n + d + s, n, d, s, out_of_range=oob, zipf=zipf)
    tv, ts = torch.from_numpy(vals).to(cuda).to(dtype), torch.from_numpy(seg).to(cuda)
    before = ops.segment_stats.launches
    got = ops.segment_stats(tv, ts, s)
    torch.cuda.synchronize()
    assert ops.segment_stats.launches == before + 1
    assert got.shape == (s, d) and got.dtype == torch.float32
    _assert_close(got, tref.segment_stats_ref(tv, ts, s), _scale(tv, ts, s), CARD_TOL)


@pytest.mark.parametrize("n,d,s,zipf", [(70_000, 289, 1, False), (70_000, 17, 4096, False),
                                        (70_000, 1, 65_536, True)])
def test_cuda_kernel_is_bit_exact_across_calls(cuda, n, d, s, zipf):
    vals, seg = _inputs(7, n, d, s, zipf=zipf)
    tv, ts = torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda)
    first = ops.segment_stats(tv, ts, s)
    second = ops.segment_stats(tv, ts, s)
    assert torch.equal(first, second)


def test_cuda_segment_sum_ignores_appended_zero_rows(cuda):
    """A segment's sum depends only on its own rows in order: zero rows
    appended to one segment and rows of other segments leave it unchanged."""
    vals, seg = _inputs(8, 9000, 17, 3)
    tv, ts = torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda)
    base = ops.segment_stats(tv, ts, 3)
    more_v = torch.cat([tv, torch.zeros((700, 17), device=cuda),
                        torch.randn((50, 17), device=cuda)])
    more_s = torch.cat([ts, torch.zeros(700, dtype=torch.int64, device=cuda),
                        torch.full((50,), 2, dtype=torch.int64, device=cuda)])
    again = ops.segment_stats(more_v, more_s, 3)
    assert torch.equal(base[:2], again[:2])


def test_cuda_empty_and_zero_segment_inputs(cuda):
    vals = torch.randn((0, 5), device=cuda)
    seg = torch.zeros((0,), dtype=torch.int64, device=cuda)
    assert torch.equal(ops.segment_stats(vals, seg, 4), torch.zeros((4, 5), device=cuda))
    vals, seg = torch.randn((10, 5), device=cuda), torch.full((10,), 9, device=cuda)
    assert torch.equal(ops.segment_stats(vals, seg, 4), torch.zeros((4, 5), device=cuda))


def test_cuda_rejects_float64_vals(cuda):
    with pytest.raises(TypeError):
        ops.segment_stats(torch.randn((4, 2), device=cuda, dtype=torch.float64),
                          torch.zeros(4, dtype=torch.int64, device=cuda), 1)


def test_segment_scores_is_a_kernel_source():
    assert "segment_scores" in build.SOURCES


@pytest.mark.parametrize("d", [1, 10, 17, 289])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_plan_reuse_matches_a_fresh_plan_and_the_plain_version(cuda, d, dtype):
    """The fit's widths: one plan reused over calls on other values gives the
    bits of a call that builds its own plan, within CARD_TOL of the plain
    version. A zipf head segment takes the long-segment path."""
    n, s = 40_000, 3000
    vals, seg = _inputs(d, n, d, s, out_of_range=True, zipf=True)
    ts = torch.from_numpy(seg).to(cuda)
    plans = ops.segment_stats.plans
    plan = ops.segment_plan(ts, s)
    assert ops.segment_stats.plans == plans + 1 and plan.n_long > 0
    for step in range(3):
        tv = (torch.from_numpy(vals) * (1.0 + step)).to(cuda).to(dtype)
        launches = ops.segment_stats.launches
        got = ops.segment_stats(tv, ts, s, plan=plan)
        assert ops.segment_stats.plans == plans + 1 + step
        fresh = ops.segment_stats(tv, ts, s)
        assert ops.segment_stats.plans == plans + 2 + step
        assert ops.segment_stats.launches == launches + 2
        torch.cuda.synchronize()
        assert torch.equal(got, fresh)
        _assert_close(got, tref.segment_stats_ref(tv, ts, s), _scale(tv, ts, s), CARD_TOL)


@pytest.mark.parametrize("d", [1, 17, 289])
def test_cuda_appended_zero_rows_are_invisible_with_a_plan(cuda, d):
    """Zero rows appended after the data, in short and long segments (and one
    short segment that they make long), leave every segment's sum bit for bit
    the same, through plans as the fit builds them."""
    vals, seg = _inputs(9 + d, 6000, d, 40)
    seg[:300] = 39                                          # a long segment
    seg[300:] = np.where(seg[300:] == 39, 38, seg[300:])
    seg[seg == 1] = 2
    seg[:250:25] = 1                                        # 10 rows: short
    tv, ts = torch.from_numpy(vals).to(cuda), torch.from_numpy(seg).to(cuda)
    base = ops.segment_stats(tv, ts, 40, plan=ops.segment_plan(ts, 40))
    pad_ids = torch.tensor([1] * 300 + [39] * 700 + [5] * 3, device=cuda)
    more_v = torch.cat([tv, torch.zeros((pad_ids.numel(), d), device=cuda)])
    more_s = torch.cat([ts, pad_ids])
    plan = ops.segment_plan(more_s, 40)
    assert 1 in plan.long_seg.tolist() and 39 in plan.long_seg.tolist()
    assert torch.equal(base, ops.segment_stats(more_v, more_s, 40, plan=plan))
