"""The port's attention kernel (``repro_torch.kernels.ops.flash_attention``)
against the JAX package, and, on a card, the CUDA kernel against its plain
version.

On the CPU the port's plain version ``flash_attention_ref`` is held against
the JAX package's ``ref.flash_attention_ref`` (jit-compiled) and against the
Pallas kernel run in interpret mode, on inputs made from a seed with numpy.
GQA cases are held against the JAX reference on K/V expanded by the model's
``_expand_kv``. Tolerances: float32 1e-5 (absolute and relative; sums of at
most a few hundred float32 products in another order); bfloat16 the 2e-2 of
``tests/test_kernels.py`` (the inputs are rounded to bfloat16 and the output
is rounded once).

The ``test_cuda_*`` tests need an NVIDIA card and skip elsewhere; they do not
import JAX. On a card, from the root of a checkout:
    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest -k cuda tests/test_torch_flash_attention.py
There the kernel is held against the plain version within float32 1e-5, and
in bfloat16 within one bfloat16 ulp of the output's scale (2^-8 of the
largest |output| plus 2^-7 relative): both compute in float32 and round once.
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's reference, Pallas kernel and GQA expansion,
    imported only by the tests that compare against them."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention
    from repro.models.layers import _expand_kv

    ref = jax.jit(jref.flash_attention_ref,
                  static_argnames=("causal", "window", "softcap", "scale"))
    return dict(jnp=jnp, ref=ref, pallas=flash_attention, expand=_expand_kv)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _qkv(seed, b, h, kv, sq, skv, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, hd)).astype(np.float32)
    k = rng.standard_normal((b, kv, skv, hd)).astype(np.float32)
    v = rng.standard_normal((b, kv, skv, hd)).astype(np.float32)
    return q, k, v


def _port(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(jnp, arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


# (name, B, H, KV, Sq, Skv, hd, causal, window, softcap)
CASES = [
    ("causal", 2, 3, 3, 64, 64, 32, True, 0, 0.0),
    ("window", 1, 2, 2, 96, 96, 32, True, 16, 0.0),
    ("softcap", 1, 2, 2, 64, 64, 32, True, 0, 50.0),
    ("softcap_window", 1, 2, 2, 64, 64, 16, True, 8, 30.0),
    ("not_causal", 2, 2, 2, 37, 53, 16, False, 0, 0.0),
    ("not_causal_window", 1, 2, 2, 40, 40, 16, False, 7, 0.0),
    ("decode", 2, 2, 2, 1, 100, 32, True, 0, 0.0),
    ("decode_window", 2, 2, 2, 1, 100, 32, True, 24, 0.0),
    ("ragged", 1, 3, 3, 7, 37, 80, True, 0, 0.0),
    ("head_dim_120", 1, 2, 2, 33, 33, 120, True, 12, 0.0),
    ("no_visible_key", 1, 2, 2, 9, 5, 16, True, 0, 0.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ref_matches_jax_ref(jax_side, case, dtype):
    name, b, h, kv, sq, skv, hd, causal, window, softcap = case
    arrays = _qkv(zlib.crc32(name.encode()), b, h, kv, sq, skv, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jax_side["ref"](*_jax(jax_side["jnp"], arrays, dtype), **kw)
    got = tref.flash_attention_ref(*_port(arrays, getattr(torch, dtype)), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, sq, hd)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# (name, B, H, KV, Sq, Skv, hd, causal, window, softcap)
GQA_CASES = [
    ("gqa_prefill_window", 2, 4, 2, 48, 48, 24, True, 16, 0.0),
    ("gqa_decode", 3, 8, 2, 1, 77, 16, True, 0, 0.0),
    ("gqa_softcap", 1, 8, 1, 20, 20, 120, True, 0, 50.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GQA_CASES, ids=[c[0] for c in GQA_CASES])
def test_gqa_ref_matches_jax_ref_on_expanded_kv(jax_side, case, dtype):
    name, b, h, kv, sq, skv, hd, causal, window, softcap = case
    jnp = jax_side["jnp"]
    q, k, v = _qkv(zlib.crc32(name.encode()), b, h, kv, sq, skv, hd)

    def expand(a):     # (B, KV, S, hd) -> the model's (B, S, H, hd) expansion
        x = jax_side["expand"](jnp.asarray(a).transpose(0, 2, 1, 3), h // kv)
        return x.transpose(0, 2, 1, 3).astype(dtype)

    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jax_side["ref"](jnp.asarray(q).astype(dtype), expand(k), expand(v), **kw)
    got = tref.flash_attention_ref(*_port((q, k, v), getattr(torch, dtype)), **kw)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# Shapes the Pallas kernel takes: Sq, Skv multiples of its blocks.
# (name, Sq, Skv, hd, blk_q, blk_k, causal, window, softcap)
PALLAS_CASES = [
    ("causal", 64, 64, 32, 32, 32, True, 0, 0.0),
    ("window", 128, 128, 16, 32, 32, True, 24, 0.0),
    ("softcap", 64, 64, 32, 32, 32, True, 0, 50.0),
    ("not_causal", 32, 64, 16, 32, 32, False, 0, 0.0),
    ("decode", 1, 256, 32, 1, 64, True, 0, 0.0),
    ("head_dim_120", 32, 64, 120, 16, 32, True, 16, 0.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PALLAS_CASES, ids=[c[0] for c in PALLAS_CASES])
def test_ref_matches_pallas_interpret(jax_side, case, dtype):
    name, sq, skv, hd, blk_q, blk_k, causal, window, softcap = case
    arrays = _qkv(zlib.crc32(name.encode()) + 1, 2, 2, 2, sq, skv, hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jax_side["pallas"](*_jax(jax_side["jnp"], arrays, dtype), blk_q=blk_q,
                              blk_k=blk_k, interpret=True, **kw)
    got = tref.flash_attention_ref(*_port(arrays, getattr(torch, dtype)), **kw)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_cpu_wrapper_takes_strided_views_and_launches_nothing():
    """The model passes (B, S, heads, hd) tensors as permuted views; on the
    CPU the wrapper runs the plain version and counts no launch."""
    q, k, v = _port(_qkv(5, 2, 4, 2, 11, 11, 24), torch.float32)
    before = ops.flash_attention.launches
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    got = ops.flash_attention(*views, window=4, scale=0.3)
    want = tref.flash_attention_ref(q, k, v, window=4, scale=0.3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("bad", ["heads", "batch", "head_dim", "dtype", "no_keys"])
def test_wrapper_rejects_bad_operands(bad):
    q, k, v = _port(_qkv(6, 1, 4, 2, 3, 5, 8), torch.float32)
    if bad == "heads":
        k, v = k[:, :1].expand(1, 3, 5, 8), v[:, :1].expand(1, 3, 5, 8)
    elif bad == "batch":
        k, v = torch.cat([k, k]), torch.cat([v, v])
    elif bad == "head_dim":
        k, v = k[..., :4], v[..., :4]
    elif bad == "dtype":
        q = q.double()
    else:
        k, v = k[:, :, :0], v[:, :, :0]
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# The CUDA kernel against its plain version (card only).
# ---------------------------------------------------------------------------

def _card_close(got, want):
    """bfloat16: kernel and plain version both compute in float32 and round
    once, so each output is within one bf16 ulp of its (b, h, i) row's scale
    plus one rounding of its own value, and over the whole output the
    relative RMS difference stays under 2^-11 (a few outputs in 2^12
    straddle a rounding boundary). float32: ``F32_TOL``."""
    if want.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        row = w.abs().amax(dim=-1, keepdim=True)
        rel_rms = float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())
        return (bool(((g - w).abs() <= 2.0 ** -8 * row + 2.0 ** -7 * w.abs()).all())
                and rel_rms <= 2.0 ** -11)
    return bool(((got - want).abs() <= F32_TOL["atol"] + F32_TOL["rtol"] * want.abs()).all())


# (name, B, H, KV, Sq, Skv, hd, causal, window, softcap, q dtype, kv dtype)
CARD_CASES = [
    ("danube_prefill_small", 1, 32, 8, 300, 300, 120, True, 96, 0.0, "bfloat16", "bfloat16"),
    ("danube_decode", 4, 32, 8, 1, 1037, 120, True, 512, 0.0, "bfloat16", "bfloat16"),
    ("gemma2_softcap", 1, 32, 16, 200, 200, 128, True, 64, 50.0, "bfloat16", "bfloat16"),
    ("ragged_not_causal", 2, 4, 4, 37, 101, 80, False, 0, 0.0, "float32", "float32"),
    ("head_dim_16", 2, 4, 2, 45, 45, 16, True, 8, 0.0, "float32", "float32"),
    ("head_dim_256", 1, 2, 1, 70, 70, 256, True, 0, 0.0, "float32", "float32"),
    ("no_visible_key", 1, 2, 2, 90, 20, 64, True, 0, 0.0, "float32", "float32"),
    ("decode_window_edge", 3, 8, 2, 1, 130, 64, True, 64, 30.0, "float32", "float32"),
    ("chunk_after_cache", 2, 8, 2, 17, 200, 120, True, 50, 0.0, "bfloat16", "bfloat16"),
    ("fp32_q_bf16_cache", 2, 4, 2, 1, 64, 32, True, 0, 0.0, "float32", "bfloat16"),
    # Split-KV (few query rows, long band): 9 runs of 8 KV tiles over the 64
    # tiles of the window, the last run empty; 11 runs without a window.
    ("split_danube_decode_full", 4, 32, 8, 1, 4640, 120, True, 4096, 0.0,
     "bfloat16", "bfloat16"),
    ("split_few_rows_full_attention", 1, 4, 4, 3, 3000, 64, True, 0, 0.0, "float32", "float32"),
]


@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_cuda_kernel_matches_plain(cuda, case):
    name, b, h, kv, sq, skv, hd, causal, window, softcap, qdt, kvdt = case
    q, k, v = _qkv(len(name) * 7919 + sq, b, h, kv, sq, skv, hd)
    q = torch.from_numpy(q).to(cuda, getattr(torch, qdt))
    k, v = (torch.from_numpy(a).to(cuda, getattr(torch, kvdt)) for a in (k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(q, k, v, **kw)
    want = tref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert _card_close(got, want), float((got.float() - want.float()).abs().max())


def test_cuda_strided_cache_views_and_replay(cuda):
    """The model's layout: q (B, S, H, hd) and a (B, S_max, KV, hd) cache
    sliced to the keys written so far, passed as permuted views; the output
    keeps q's layout; two calls give the same bits; one launch each."""
    b, s_max, kv, h, hd, pos = 2, 300, 2, 8, 120, 257
    gen = torch.Generator(device=cuda).manual_seed(0)
    cache_k = torch.randn((b, s_max, kv, hd), generator=gen, device=cuda).bfloat16()
    cache_v = torch.randn((b, s_max, kv, hd), generator=gen, device=cuda).bfloat16()
    q = torch.randn((b, 3, h, hd), generator=gen, device=cuda).bfloat16()
    qv = q.permute(0, 2, 1, 3)
    kv_k = cache_k[:, :pos].permute(0, 2, 1, 3)
    kv_v = cache_v[:, :pos].permute(0, 2, 1, 3)
    before = ops.flash_attention.launches
    got = ops.flash_attention(qv, kv_k, kv_v, window=100)
    again = ops.flash_attention(qv, kv_k, kv_v, window=100)
    want = tref.flash_attention_ref(qv.contiguous(), kv_k.contiguous(), kv_v.contiguous(),
                                    window=100)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 2
    assert got.stride() == qv.stride()
    assert torch.equal(got, again)
    assert _card_close(got, want)


def test_split_counts():
    """Split-KV only where the blocks alone cannot fill 132 SMs twice, and
    every run keeps at least 4 KV tiles of the band."""
    from repro_torch.kernels.flash_attention import n_splits
    assert n_splits(4, 32, 8, 1, 4640, True, 4096, 132) == 9
    assert n_splits(1, 4, 4, 3, 3000, True, 0, 132) == 11
    assert n_splits(1, 32, 8, 4608, 4608, True, 4096, 132) == 1
    assert n_splits(4, 32, 8, 1, 100, True, 4096, 132) == 1


def test_cuda_rejects_head_dim_over_256(cuda):
    q = torch.zeros((1, 1, 2, 264), device=cuda)
    with pytest.raises(ValueError, match="hd <= 256"):
        ops.flash_attention(q, q, q)
