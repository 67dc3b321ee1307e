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
from repro_torch.kernels import ref as tref

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


def test_cuda_mixed_devices_raise(cuda):
    w, b, h, ids = (torch.from_numpy(a) for a in _gather_inputs(0, 50, 16, 7, 5))
    with pytest.raises(ValueError, match="several devices"):
        ops.gather_scores(w.to(cuda), b.to(cuda), h, ids.to(cuda))
