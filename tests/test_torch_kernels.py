"""The port's kernels (repro_torch.kernels) against the JAX package's plain
references, and, on a card, each CUDA kernel against its plain version.

The JAX side is ``repro.kernels.ref`` (jit-compiled on the CPU); its Pallas
kernels are not the reference here. Inputs are made from a seed with numpy
and given to both packages. Tolerances are float32: 1e-5 for one dot
product, 1e-4 absolute for tree log-probs summed over depth levels.

The ``test_cuda_*`` tests need an NVIDIA card and skip elsewhere; they do not
import JAX. On a card, from the root of a checkout:
    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest -k cuda tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import tree as tree_lib
from repro_torch.kernels import build, ops
from repro_torch.kernels import gather_scores as gsc
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tree_logprob as tlp

TOL = dict(atol=1e-5, rtol=1e-5)
TREE_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's references, imported only by the tests that
    compare against them (the card tests run where JAX is absent)."""
    import jax
    import jax.numpy as jnp
    from repro.core import tree as jtree
    from repro.kernels import ref as jref

    return dict(
        jnp=jnp,
        gather=jax.jit(jref.gather_scores_ref),
        tree_all=jax.jit(jref.tree_logprob_all_ref),
        force_padding=jtree._force_padding)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _gather_inputs(seed, c, kdim, t, n):
    rng = np.random.default_rng(seed)
    w = (0.5 * rng.standard_normal((c, kdim))).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    h = rng.standard_normal((t, kdim)).astype(np.float32)
    ids = rng.integers(0, c, (t, n))
    return w, b, h, ids


def _tree_inputs(seed, c, k, bsz, force_padding):
    """Random node tables with the padding pattern of a C-label tree."""
    rng = np.random.default_rng(seed)
    c_pad = tree_lib.padded_size(c)
    w = (0.7 * rng.standard_normal((c_pad - 1, k))).astype(np.float32)
    b = (0.3 * rng.standard_normal(c_pad - 1)).astype(np.float32)
    b = np.array(force_padding(b, c, c_pad), np.float32)
    x = rng.standard_normal((bsz, k)).astype(np.float32)
    return w, b, x


# ---------------------------------------------------------------------------
# Plain versions against the JAX package (CPU).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 5, 64])
@pytest.mark.parametrize("t", [1, 7, 300])
def test_gather_scores_ref_matches_jax(jax_side, t, n, dtype):
    jnp = jax_side["jnp"]
    w, b, h, ids = _gather_inputs(t * 100 + n, 300, 64, t, n)
    jw, jb = jnp.asarray(w).astype(dtype), jnp.asarray(b).astype(dtype)
    want = np.asarray(jax_side["gather"](jw, jb, jnp.asarray(h),
                                         jnp.asarray(ids, jnp.int32)))
    tdt = getattr(torch, dtype)
    got = tref.gather_scores_ref(torch.from_numpy(w).to(tdt),
                                 torch.from_numpy(b).to(tdt),
                                 torch.from_numpy(h), torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (t, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bsz", [1, 3, 130])
@pytest.mark.parametrize("c", [2, 100, 256])
def test_tree_logprob_all_ref_matches_jax(jax_side, c, bsz):
    jnp = jax_side["jnp"]
    w, b, x = _tree_inputs(c + bsz, c, 8, bsz, jax_side["force_padding"])
    want = np.asarray(jax_side["tree_all"](jnp.asarray(w), jnp.asarray(b),
                                           jnp.asarray(x)))
    got = tref.tree_logprob_all_ref(torch.from_numpy(w), torch.from_numpy(b),
                                    torch.from_numpy(x))
    assert got.shape == (bsz, tree_lib.padded_size(c))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **TREE_TOL)


def test_tree_logprob_all_ref_bf16_tables_match_jax(jax_side):
    jnp = jax_side["jnp"]
    w, b, x = _tree_inputs(5, 100, 8, 3, jax_side["force_padding"])
    want = np.asarray(jax_side["tree_all"](
        jnp.asarray(w).astype("bfloat16").astype("float32"),
        jnp.asarray(b).astype("bfloat16").astype("float32"), jnp.asarray(x)))
    got = tref.tree_logprob_all_ref(torch.from_numpy(w).bfloat16(),
                                    torch.from_numpy(b).bfloat16(),
                                    torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TREE_TOL)


# ---------------------------------------------------------------------------
# Wrappers on the CPU: the plain version, no launch, the same checks.
# ---------------------------------------------------------------------------

def _cpu_operands(name):
    if name == "gather_scores":
        w, b, h, ids = _gather_inputs(0, 50, 16, 7, 5)
        args = tuple(torch.from_numpy(a) for a in (w, b, h, ids))
        return ops.gather_scores, tref.gather_scores_ref, args
    w, b, x = _tree_inputs(0, 50, 4, 7, lambda b, c, p: b)
    args = tuple(torch.from_numpy(a) for a in (w, b, x))
    return ops.tree_logprob_all, tref.tree_logprob_all_ref, args


@pytest.mark.parametrize("name", ["gather_scores", "tree_logprob_all"])
def test_cpu_tensors_take_the_plain_version(name):
    wrapper, plain, args = _cpu_operands(name)
    before = wrapper.launches
    out = wrapper(*args)
    assert wrapper.launches == before
    torch.testing.assert_close(out, plain(*args), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["int32_ids", "float64_h", "ids_rows", "h_width",
                                 "bias_dtype", "strided_h"])
def test_gather_scores_rejects_what_the_kernel_does_not_take(bad):
    w, b, h, ids = (torch.from_numpy(a) for a in _gather_inputs(0, 50, 16, 7, 5))
    if bad == "int32_ids":
        ids = ids.int()
    elif bad == "float64_h":
        h = h.double()
    elif bad == "ids_rows":
        ids = ids[:3]
    elif bad == "h_width":
        h = h[:, :8].contiguous()
    elif bad == "bias_dtype":
        b = b.bfloat16()
    else:
        h = torch.cat([h, h], dim=1)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        ops.gather_scores(w, b, h, ids)


@pytest.mark.parametrize("bad", ["not_2d_minus_1", "k_mismatch", "bf16_x",
                                 "strided_x"])
def test_tree_logprob_all_rejects_what_the_kernel_does_not_take(bad):
    w, b, x = (torch.from_numpy(a) for a in _tree_inputs(0, 50, 4, 7,
                                                         lambda b, c, p: b))
    if bad == "not_2d_minus_1":
        w, b = w[:-1], b[:-1]
    elif bad == "k_mismatch":
        x = x[:, :3].contiguous()
    elif bad == "bf16_x":
        x = x.bfloat16()
    else:
        x = torch.cat([x, x], dim=1)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        ops.tree_logprob_all(w, b, x)


@pytest.mark.parametrize("bsz,depth,want", [
    (256, 18, (tlp.TENSOR_CORES, 16, 16)),   # dense prediction: 1,024 blocks
    (4, 15, (tlp.TENSOR_CORES, 1, 8)),       # LM serving: 128 leaf blocks, halves
    (256, 15, (tlp.TENSOR_CORES, 4, 16)),
    (300, 8, (tlp.TENSOR_CORES, 1, 8)),      # one leaf block: as many blocks as it can
    (1, 30, (tlp.TENSOR_CORES, 1, 16)),
    (5, 7, (tlp.FMA, 0, 0)),                 # under 256 leaves: the FMA kernel
    (256, 1, (tlp.FMA, 0, 0)),
])
def test_tree_logprob_launch_plan(bsz, depth, want):
    assert tlp.launch_plan(bsz, depth, 132) == want


@pytest.mark.parametrize("sm_count", [1, 132])
def test_tree_logprob_launch_plan_fills_the_card_within_its_limits(sm_count):
    for bsz in (1, 4, 5, 16, 17, 100, 256, 300, 5000):
        for depth in range(tlp.TENSOR_CORE_MIN_DEPTH, 21):
            kernel, groups, sub = tlp.launch_plan(bsz, depth, sm_count)
            assert kernel == tlp.TENSOR_CORES
            assert 1 <= groups <= 16 and sub in (8, 16)
            row_groups = -(-bsz // 16)
            assert groups <= row_groups
            blocks = (1 << (depth - 8)) * (16 // sub) * -(-row_groups // groups)
            # Fewer than two blocks an SM only once nothing is left to halve.
            assert blocks >= 2 * sm_count or (groups == 1 and sub == 8)


@pytest.mark.parametrize("t,n,k,itemsize,want", [
    (4, 64, 3840, 4, (gsc.SPLIT, 256, 1)),   # LM-serving beam: a block a row, 256 blocks
    (256, 64, 512, 4, (gsc.ROWS, 16, 4)),    # prediction beam: a block a token, two rounds
    (256, 64, 512, 2, (gsc.ROWS, 16, 4)),    # the same, bfloat16
    (1, 1, 512, 4, (gsc.SPLIT, 128, 1)),     # one row: a chunk a lane
    (1, 1, 3840, 4, (gsc.SPLIT, 256, 1)),
    (7, 5, 50, 4, (gsc.ROWS, 16, 1)),        # K not a multiple of a 16-byte chunk
    (4, 64, 3841, 4, (gsc.SPLIT, 256, 1)),
    (4, 64, 16384, 4, (gsc.SPLIT, 256, 1)),  # a row longer than a block's round: 4 rounds
    (2, 3, 1_000_000, 2, (gsc.SPLIT, 256, 1)),
])
def test_gather_scores_launch_plan(t, n, k, itemsize, want):
    assert gsc.launch_plan(t, n, k, itemsize, 132) == want


@pytest.mark.parametrize("sm_count", [1, 78, 132])
def test_gather_scores_launch_plan_fills_the_card_within_its_limits(sm_count):
    for t in (1, 4, 7, 256, 5000):
        for n in (1, 3, 5, 64, 300):
            for k in (1, 4, 50, 512, 513, 3840, 3841, 12289, 100_000):
                for itemsize in (4, 2):
                    variant, lanes, rows = gsc.launch_plan(t, n, k, itemsize, sm_count)
                    c = gsc.chunks(k, itemsize)
                    assert lanes in (8, 16, 32, 64, 128, 256) and rows in (1, 2, 4)
                    assert variant == (gsc.ROWS if lanes <= 32 else gsc.SPLIT)
                    assert rows <= n
                    # Never a row over more lanes than twice its chunks (so
                    # never over more warps than it has chunks), and at most
                    # two rounds a lane unless a whole block takes the row.
                    assert lanes < 2 * c or lanes == 8
                    assert variant == gsc.ROWS or lanes // 32 <= c
                    assert gsc.rounds(c, itemsize, lanes) <= 2 or lanes == 256
                    blocks = gsc.blocks(t, n, lanes, rows)
                    # At least one block an SM unless nothing is left to
                    # split, and within one wave (BLOCKS_PER_SM an SM)
                    # unless narrower groups would take more than two rounds.
                    assert blocks >= sm_count or (
                        rows == 1 and (lanes == 256 or lanes >= c))
                    assert blocks <= gsc.BLOCKS_PER_SM * sm_count or lanes == 8 or (
                        gsc.rounds(c, itemsize, lanes // 2) > 2)


class _FakeGatherLibrary:
    """A stand-in for the kernel's library: entry points that take
    ctypes attributes, and the launch bounds' blocks an SM."""

    def __init__(self, blocks_per_sm):
        fn = type("Entry", (), {"__call__": lambda self, *a: 0})
        self.gather_scores_f32, self.gather_scores_bf16 = fn(), fn()
        self.gather_scores_blocks_per_sm = type(
            "Entry", (), {"__call__": lambda self: blocks_per_sm})()


@pytest.mark.parametrize("blocks_per_sm", [1, 3])
def test_gather_scores_refuses_a_library_of_another_occupancy(monkeypatch, blocks_per_sm):
    """launch_plan's wave assumes the kernel's launch bounds: a library
    whose bounds promise another count of blocks an SM is not used."""
    monkeypatch.setattr(build, "load", lambda name: _FakeGatherLibrary(blocks_per_sm))
    gsc._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="blocks an SM"):
            gsc._lib()
        monkeypatch.setattr(build, "load",
                            lambda name: _FakeGatherLibrary(gsc.BLOCKS_PER_SM))
        gsc._lib.cache_clear()
        assert gsc._lib().gather_scores_blocks_per_sm() == gsc.BLOCKS_PER_SM
    finally:
        gsc._lib.cache_clear()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_library_name_follows_the_source():
    names = {build.library_path(n).name for n in build.SOURCES}
    assert len(names) == len(build.SOURCES)
    assert all(n.startswith("lib") and n.endswith(".so") for n in names)
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")


# ---------------------------------------------------------------------------
# On a card: each kernel against its plain version.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kdim", [50, 512])
@pytest.mark.parametrize("t,n", [(1, 1), (7, 5), (300, 64)])
def test_cuda_gather_scores_kernel_matches_plain(cuda, t, n, kdim, dtype):
    w, b, h, ids = (torch.from_numpy(a).to(cuda)
                    for a in _gather_inputs(t + n + kdim, 1000, kdim, t, n))
    w, b = w.to(dtype), b.to(dtype)
    before = ops.gather_scores.launches
    got = ops.gather_scores(w, b, h, ids)
    torch.cuda.synchronize()
    assert ops.gather_scores.launches == before + 1
    torch.testing.assert_close(got, tref.gather_scores_ref(w, b, h, ids), **TOL)


def test_cuda_gather_scores_out_of_range_id_is_nan(cuda):
    w, b, h, ids = (torch.from_numpy(a).to(cuda)
                    for a in _gather_inputs(1, 100, 32, 4, 3))
    ids[1, 2] = 100
    ids[2, 0] = -1
    got = ops.gather_scores(w, b, h, ids).cpu()
    assert torch.isnan(got[1, 2]) and torch.isnan(got[2, 0])
    assert torch.isfinite(got).sum() == got.numel() - 2


def _gather_case(device, seed, c, kdim, t, n, dtype):
    """Inputs at a model's scale (w ~ N(0, 1/K)), so one float32 dot stays
    within TOL of another summed in another order."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((c, kdim)) / np.sqrt(kdim)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    h = rng.standard_normal((t, kdim)).astype(np.float32)
    ids = rng.integers(0, c, (t, n))
    w, b, h, ids = (torch.from_numpy(a).to(device) for a in (w, b, h, ids))
    return w.to(dtype), b.to(dtype), h, ids


def _bits(x):
    return x.view(torch.int32)


# Every variant and split a plan can give, forced through the launch.
GATHER_PLANS = [(gsc.ROWS, 8, 1), (gsc.ROWS, 16, 2), (gsc.ROWS, 32, 4), (gsc.ROWS, 8, 4),
                (gsc.SPLIT, 64, 4), (gsc.SPLIT, 128, 2), (gsc.SPLIT, 256, 1),
                (gsc.SPLIT, 256, 2), (gsc.SPLIT, 128, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kdim", [50, 512, 3840, 3841])
@pytest.mark.parametrize("plan", GATHER_PLANS)
def test_cuda_gather_scores_each_plan_matches_plain(cuda, plan, kdim, dtype):
    """Each variant and split against the plain version: aligned rows (K =
    512, 3,840) and ragged ones read element by element (K = 50, 3,841); n =
    37 over the 32 slots a block takes at most; an id outside [0, C) scores
    NaN; two calls give the same bits; the variant's counter moves."""
    c, t, n = 1000, 5, 37
    w, b, h, ids = _gather_case(cuda, kdim + plan[1] + plan[2], c, kdim, t, n, dtype)
    ids[0, 3], ids[4, 36], ids[2, 0] = c, -1, c + 77
    bad = (ids < 0) | (ids >= c)
    out, again = (torch.empty((t, n), device=cuda) for _ in range(2))
    before = (gsc.gather_scores.rows_launches, gsc.gather_scores.split_launches)
    gsc._launch(w, b, h, ids, out, *plan)
    gsc._launch(w, b, h, ids, again, *plan)
    torch.cuda.synchronize()
    after = (gsc.gather_scores.rows_launches, gsc.gather_scores.split_launches)
    assert (after[0] - before[0], after[1] - before[1]) == (
        (2, 0) if plan[0] == gsc.ROWS else (0, 2))
    assert torch.equal(_bits(out), _bits(again))
    assert torch.equal(torch.isnan(out), bad)
    want = tref.gather_scores_ref(w, b, h, ids.clamp(0, c - 1))
    torch.testing.assert_close(out[~bad], want[~bad], **TOL)


@pytest.mark.parametrize("shifted", ["w", "h"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gather_scores_unaligned_rows(cuda, shifted, dtype):
    """Rows of w or h that do not start on 16 bytes (a table sliced one
    element in) take the element-by-element path under the plan."""
    c, kdim, t, n = 700, 512, 6, 64
    w, b, h, ids = _gather_case(cuda, 3, c, kdim, t, n, dtype)
    if shifted == "w":
        w = torch.cat([w.new_zeros(1), w.reshape(-1)])[1:].view(c, kdim)
        assert w.data_ptr() % 16 != 0
    else:
        h = torch.cat([h.new_zeros(1), h.reshape(-1)])[1:].view(t, kdim)
        assert h.data_ptr() % 16 != 0
    got = ops.gather_scores(w, b, h, ids)
    again = ops.gather_scores(w, b, h, ids)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, tref.gather_scores_ref(w, b, h, ids), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,n,kdim,variant", [
    (4, 64, 3840, gsc.SPLIT),     # the LM-serving beam path's call
    (256, 64, 512, gsc.ROWS),     # the prediction beam path's call
    (1, 1, 512, gsc.SPLIT),
    (4, 64, 16384, gsc.SPLIT),    # a row in 4 rounds of a block
])
def test_cuda_gather_scores_plans_the_main_paths(cuda, t, n, kdim, variant, dtype):
    """The plan of the main paths' shapes takes the variant it names, counted
    by its own counter, and two calls give the same bits."""
    w, b, h, ids = _gather_case(cuda, t + n, 1024, kdim, t, n, dtype)
    sm_count = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert gsc.launch_plan(t, n, kdim, w.element_size(), sm_count)[0] == variant
    counter = "rows_launches" if variant == gsc.ROWS else "split_launches"
    before = (getattr(ops.gather_scores, counter), ops.gather_scores.launches)
    got = ops.gather_scores(w, b, h, ids)
    again = ops.gather_scores(w, b, h, ids)
    torch.cuda.synchronize()
    assert (getattr(ops.gather_scores, counter), ops.gather_scores.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, tref.gather_scores_ref(w, b, h, ids), **TOL)


@pytest.mark.parametrize("plan", [(gsc.ROWS, 64, 1), (gsc.SPLIT, 32, 1),
                                  (gsc.ROWS, 32, 3), (gsc.ROWS, 4, 1),
                                  (gsc.ROWS, 16, 8), (gsc.SPLIT, 128, 3),
                                  (gsc.SPLIT, 96, 1), (2, 32, 1),
                                  (gsc.SPLIT, 64, 8)])
def test_cuda_gather_scores_entry_refuses_a_plan_it_cannot_run(cuda, plan):
    """The C entry checks the plan again: ROWS takes 8 to 32 lanes, SPLIT
    64 to 256 lanes, powers of two; rows 1, 2 or 4."""
    w, b, h, ids = _gather_case(cuda, 0, 50, 4, 3, 5, torch.float32)
    out = torch.empty((3, 5), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        gsc._launch(w, b, h, ids, out, *plan)


def test_cuda_gather_scores_library_bounds_match_the_plan(cuda):
    """The built kernel's launch bounds promise the blocks an SM that
    launch_plan's wave assumes."""
    assert gsc._lib().gather_scores_blocks_per_sm() == gsc.BLOCKS_PER_SM


@pytest.mark.parametrize("bsz", [1, 3, 130])
@pytest.mark.parametrize("c", [2, 100, 256, 5000])
def test_cuda_tree_logprob_all_kernel_matches_plain(cuda, c, bsz):
    gen = torch.Generator().manual_seed(c + bsz)
    tree = tree_lib.init_tree(gen, c, 16, scale=1.0, device="cpu")
    x = torch.randn((bsz, 16), generator=gen)
    w, b, x = tree.w.to(cuda), tree.b.to(cuda), x.to(cuda)
    before = ops.tree_logprob_all.launches
    got = ops.tree_logprob_all(w, b, x)
    torch.cuda.synchronize()
    assert ops.tree_logprob_all.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, tref.tree_logprob_all_ref(w, b, x), **TREE_TOL)


def _tree_tables(seed, depth, k, bsz, device):
    rng = np.random.default_rng(seed)
    n = (1 << depth) - 1
    w = rng.standard_normal((n, k)).astype(np.float32)
    b = (0.3 * rng.standard_normal(n)).astype(np.float32)
    x = rng.standard_normal((bsz, k)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (w, b, x))


@pytest.mark.parametrize("k", [1, 16, 31, 32])
@pytest.mark.parametrize("depth", [1, 8, 9, 15, 18])
@pytest.mark.parametrize("bsz", [1, 4, 5, 256, 300])
def test_cuda_tree_logprob_all_kernel_paths(cuda, bsz, depth, k):
    """Both kernels, at the shapes where the launch plan and the tensor-core
    kernel's tiling branch (depth 8: no prefix; 9: one; small B: sub-blocks
    spread over warps; B = 300: a ragged second row chunk; k = 1, 31: padded
    k steps), against the plain version; two calls bit-equal."""
    w, b, x = _tree_tables(bsz * 1000 + depth * 40 + k, depth, k, bsz, cuda)
    kernel = tlp.launch_plan(bsz, depth, torch.cuda.get_device_properties(cuda).multi_processor_count)[0]
    before = (ops.tree_logprob_all.tensor_core_launches, ops.tree_logprob_all.fma_launches)
    got = ops.tree_logprob_all(w, b, x)
    again = ops.tree_logprob_all(w, b, x)
    torch.cuda.synchronize()
    after = (ops.tree_logprob_all.tensor_core_launches, ops.tree_logprob_all.fma_launches)
    tc = kernel == tlp.TENSOR_CORES
    assert (after[0] - before[0], after[1] - before[1]) == ((2, 0) if tc else (0, 2))
    assert tc == (depth >= 8)
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, tref.tree_logprob_all_ref(w, b, x), **TREE_TOL)


@pytest.mark.parametrize("depth", [8, 15])
def test_cuda_tree_logprob_fma_kernel_takes_any_depth(cuda, depth):
    """The FMA kernel, which the plan keeps for small trees, still computes
    deep ones (chip_smoke.py times it beside the tensor-core kernel)."""
    w, b, x = _tree_tables(depth, depth, 32, 4, cuda)
    out = torch.empty((4, 1 << depth), device=cuda)
    tlp._launch(w, b, x, out, depth, tlp.FMA, 0, 0)
    torch.testing.assert_close(out, tref.tree_logprob_all_ref(w, b, x), **TREE_TOL)


@pytest.mark.parametrize("plan", [(tlp.TENSOR_CORES, 1, 16), (tlp.TENSOR_CORES, 0, 16),
                                  (tlp.TENSOR_CORES, 17, 16), (tlp.TENSOR_CORES, 1, 12),
                                  (2, 0, 0)])
def test_cuda_tree_logprob_entry_refuses_a_plan_it_cannot_run(cuda, plan):
    """The C entry checks the plan again: the tensor-core kernel needs depth
    >= 8, 1..16 row groups and a power of two of sub-blocks."""
    depth = 7 if plan == (tlp.TENSOR_CORES, 1, 16) else 9
    w, b, x = _tree_tables(0, depth, 16, 4, cuda)
    out = torch.empty((4, 1 << depth), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        tlp._launch(w, b, x, out, depth, *plan)


def test_cuda_mixed_devices_raise(cuda):
    w, b, h, ids = (torch.from_numpy(a) for a in _gather_inputs(0, 50, 16, 7, 5))
    with pytest.raises(ValueError, match="several devices"):
        ops.gather_scores(w.to(cuda), b.to(cuda), h, ids.to(cuda))
