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
There the kernels are held against the plain version within float32 1e-5,
and in bfloat16 within one bfloat16 ulp of each output row's scale (2^-8 of
the row's largest |output| plus 2^-7 relative) and 2^-11 relative RMS over
the output: both compute in float32 (the tensor-core kernel multiplies bf16
values exactly and keeps P as bf16 hi + lo, ~2^-17 of P) and round once.
On the CPU, ``decode_path`` and ``tensor_core_path`` (which kernel a call
takes) and ``decode_splits`` are checked case by case, and an emulation of
the tensor-core kernel's P V numerics shows why P is split: hi + lo meets
the 2^-11 bound, P rounded to bf16 once does not. On a card the decode
kernel (bf16, at most 16 packed rows) is held the same way over G = 1, 2,
4 and 8, hd 8 to 256, softcap, windows, ragged Skv and split KV ranges.
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import decode_path, decode_splits, tensor_core_path

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


def _layout(kind, b, h, kv, sq, skv, hd, dtype=torch.bfloat16):
    """q, k, v as a call passes them: "contiguous" (B, heads, S, hd) tensors,
    or "model" (the model's (B, S, heads, hd) projection and a (B, S + 32,
    KV, hd) cache sliced to Skv, permuted)."""
    if kind == "contiguous":
        return (torch.zeros((b, h, sq, hd), dtype=dtype),
                torch.zeros((b, kv, skv, hd), dtype=dtype),
                torch.zeros((b, kv, skv, hd), dtype=dtype))
    cache = torch.zeros((2, b, skv + 32, kv, hd), dtype=dtype)
    q = torch.zeros((b, sq, h, hd), dtype=dtype).transpose(1, 2)
    return q, cache[0, :, :skv].transpose(1, 2), cache[1, :, :skv].transpose(1, 2)


# (name, layout, B, H, KV, Sq, Skv, hd, dtype, split, tensor-core path?)
PATH_CASES = [
    ("danube_prefill", "model", 1, 32, 8, 300, 300, 120, torch.bfloat16, 1, True),
    ("stablelm_prefill", "model", 1, 32, 32, 70, 70, 80, torch.bfloat16, 1, True),
    ("gemma2_chunk_after_cache", "model", 1, 32, 16, 9, 100, 128, torch.bfloat16, 1, True),
    ("contiguous_hd_64", "contiguous", 2, 4, 4, 300, 300, 64, torch.bfloat16, 1, True),
    ("packed_rows_17", "contiguous", 1, 1, 1, 17, 17, 64, torch.bfloat16, 1, True),
    ("packed_rows_16", "contiguous", 1, 4, 1, 4, 40, 64, torch.bfloat16, 1, False),
    ("danube_decode", "model", 4, 32, 8, 1, 1000, 120, torch.bfloat16, 1, False),
    ("float32_prefill", "contiguous", 1, 4, 2, 300, 300, 64, torch.float32, 1, False),
    ("hd_136", "contiguous", 1, 4, 2, 300, 300, 136, torch.bfloat16, 1, False),
    ("hd_not_multiple_of_8", "contiguous", 1, 4, 2, 300, 300, 36, torch.bfloat16, 1, False),
    ("split_kv", "contiguous", 1, 4, 2, 300, 300, 64, torch.bfloat16, 2, False),
]


@pytest.mark.parametrize("case", PATH_CASES, ids=[c[0] for c in PATH_CASES])
def test_tensor_core_path(case):
    """Which kernel a CUDA call takes, read from the operands alone."""
    name, kind, b, h, kv, sq, skv, hd, dtype, split, want = case
    q, k, v = _layout(kind, b, h, kv, sq, skv, hd, dtype)
    assert tensor_core_path(q, k, v, split) is want


@pytest.mark.parametrize("bad", ["q_pointer", "k_pointer", "q_stride", "v_stride",
                                 "mixed_dtypes"])
def test_tensor_core_path_needs_aligned_bf16_operands(bad):
    """A bf16 prefill that meets the rule but for one operand's 16-byte
    alignment or dtype takes the FMA kernel."""
    q, k, v = _layout("model", 1, 8, 2, 100, 100, 64)
    assert tensor_core_path(q, k, v, 1)
    if bad == "q_pointer":      # base pointer 2 bytes past an aligned one
        q = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    elif bad == "k_pointer":
        k = torch.zeros(k.numel() + 1, dtype=k.dtype)[1:].view(k.shape)
    elif bad == "q_stride":     # rows of 8 * 64 + 4 elements: a 1,032-byte stride
        q = torch.zeros((1, 100, 8 * 64 + 4), dtype=q.dtype)[..., :8 * 64]
        q = q.view(1, 100, 8, 64).transpose(1, 2)
    elif bad == "v_stride":
        v = torch.zeros((1, 100, 2, 68), dtype=v.dtype)[..., :64].transpose(1, 2)
    else:
        v = v.float()
    assert not tensor_core_path(q, k, v, 1)


# (name, layout, B, H, KV, Sq, Skv, hd, dtype, decode path?)
DECODE_PATH_CASES = [
    ("danube_decode", "model", 4, 32, 8, 1, 1000, 120, torch.bfloat16, True),
    ("gemma2_decode", "model", 4, 32, 16, 1, 1000, 128, torch.bfloat16, True),
    ("stablelm_decode", "model", 4, 32, 32, 1, 1000, 80, torch.bfloat16, True),
    ("packed_rows_16", "contiguous", 1, 4, 1, 4, 40, 64, torch.bfloat16, True),
    ("hd_256", "contiguous", 1, 4, 2, 1, 300, 256, torch.bfloat16, True),
    ("hd_8", "contiguous", 1, 8, 4, 1, 5, 8, torch.bfloat16, True),
    ("packed_rows_17", "contiguous", 1, 1, 1, 17, 17, 64, torch.bfloat16, False),
    ("danube_prefill", "model", 1, 32, 8, 300, 300, 120, torch.bfloat16, False),
    ("float32_decode", "model", 4, 32, 8, 1, 1000, 120, torch.float32, False),
    ("hd_not_multiple_of_8", "contiguous", 1, 4, 2, 1, 300, 36, torch.bfloat16, False),
]


@pytest.mark.parametrize("case", DECODE_PATH_CASES, ids=[c[0] for c in DECODE_PATH_CASES])
def test_decode_path(case):
    """Which calls the decode kernel takes, read from the operands alone; no
    call meets both its rule and the tensor-core kernel's."""
    name, kind, b, h, kv, sq, skv, hd, dtype, want = case
    q, k, v = _layout(kind, b, h, kv, sq, skv, hd, dtype)
    assert decode_path(q, k, v) is want
    assert not (decode_path(q, k, v) and tensor_core_path(q, k, v, 1))


@pytest.mark.parametrize("bad", ["q_pointer", "k_pointer", "q_stride", "v_stride",
                                 "mixed_dtypes"])
def test_decode_path_needs_aligned_bf16_operands(bad):
    """h2o-danube decode in the model's layout takes the decode kernel, but
    not with one operand 2 bytes off 16-byte alignment or of another dtype."""
    q, k, v = _layout("model", 2, 32, 8, 1, 500, 120)
    assert decode_path(q, k, v)
    if bad == "q_pointer":
        q = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    elif bad == "k_pointer":
        k = torch.zeros(k.numel() + 1, dtype=k.dtype)[1:].view(k.shape)
    elif bad == "q_stride":     # rows of 32 * 120 + 4 elements
        q = torch.zeros((2, 1, 32 * 120 + 4), dtype=q.dtype)[..., :32 * 120]
        q = q.view(2, 1, 32, 120).transpose(1, 2)
    elif bad == "v_stride":
        v = torch.zeros((2, 500, 8, 124), dtype=v.dtype)[..., :120].transpose(1, 2)
    else:
        k = k.float()
    assert not decode_path(q, k, v)


def test_decode_split_counts():
    """The decode kernel's KV range is split so that 132 SMs get about 3
    blocks each in one wave, every split at least 256 keys of the band."""
    assert decode_splits(4, 32, 8, 1, 4640, True, 4096, 132) == 12      # (b): 384 blocks
    assert decode_splits(4, 32, 16, 1, 2080, True, 4096, 132) == 6      # gemma2 decode
    assert decode_splits(4, 32, 32, 1, 2080, True, 0, 132) == 3         # stablelm decode
    assert decode_splits(4, 32, 8, 1, 1037, True, 512, 132) == 2        # the band is short
    assert decode_splits(1, 4, 1, 4, 300, True, 0, 132) == 1            # 16 rows, 300 keys
    assert decode_splits(64, 32, 8, 1, 4640, True, 4096, 132) == 1      # blocks enough


def _tc_emulation(q, k, v, *, split_p, window=0, block=64):
    """The tensor-core kernel's numerics on the CPU, causal, scale 1: bf16
    q, k, v; S in float32 (exact bf16 products); an online softmax over KV
    tiles of ``block`` keys in float32; P V with P rounded to bf16 (hi) and,
    with ``split_p``, its residual rounded to bf16 (lo), each product exact,
    summed in float32; finalised as acc / l and rounded once to bf16."""
    b, h, sq, hd = q.shape
    g = h // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    qpos = torch.arange(sq) + (k.shape[2] - sq)
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, hd))
    for k0 in range(0, k.shape[2], block):
        s = q.float() @ kf[:, :, k0:k0 + block].transpose(-1, -2)
        delta = qpos[:, None] - torch.arange(k0, k0 + s.shape[-1])[None, :]
        seen = (delta >= 0) & ((delta < window) if window else True)
        s = torch.where(seen, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k0:k0 + block]
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k0:k0 + block]
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


@pytest.mark.parametrize("split_p", [True, False], ids=["p_hi_plus_lo", "p_rounded_once"])
def test_tensor_core_p_split_meets_bf16_bound(split_p):
    """P V with P as bf16 hi + lo stays within the card check's 2^-11
    relative RMS of the plain version (both bf16 outputs); P rounded to
    bf16 once does not. q scaled by 1/sqrt(hd) in bf16, as the model calls
    the kernel."""
    rng = np.random.default_rng(16)
    b, h, kv, s, hd, window = 1, 8, 2, 256, 64, 96
    q = torch.from_numpy(rng.standard_normal((b, h, s, hd), dtype=np.float32))
    q = (q.bfloat16() * torch.tensor(hd ** -0.5).bfloat16())
    k, v = (torch.from_numpy(rng.standard_normal((b, kv, s, hd), dtype=np.float32)).bfloat16()
            for _ in range(2))
    got = _tc_emulation(q, k, v, split_p=split_p, window=window).float()
    want = tref.flash_attention_ref(q, k, v, window=window, scale=1.0).float()
    rel_rms = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    assert (rel_rms <= 2.0 ** -11) is split_p, rel_rms


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
    # The tensor-core kernel (bf16, more than 16 packed rows, hd <= 128):
    # hd 64 / 80 / 120 / 128 / 40 and 8 (padded), G = 1 / 2 / 4 / 8, packed
    # rows not a multiple of the 64-row tile, a window edge inside a KV
    # tile, a chunk after a cache, rows with no visible key, softcap; each
    # with enough blocks that the KV range is not split.
    ("tc_hd64_g1", 2, 4, 4, 300, 300, 64, True, 0, 0.0, "bfloat16", "bfloat16"),
    ("tc_hd80_g2_not_causal", 3, 8, 4, 1000, 1000, 80, False, 0, 0.0, "bfloat16", "bfloat16"),
    ("tc_hd120_g4_window_mid_tile", 1, 8, 2, 1000, 1000, 120, True, 100, 0.0,
     "bfloat16", "bfloat16"),
    ("tc_hd128_g8", 1, 16, 2, 300, 300, 128, True, 0, 0.0, "bfloat16", "bfloat16"),
    ("tc_hd40_g2", 1, 4, 2, 77, 77, 40, True, 0, 0.0, "bfloat16", "bfloat16"),
    ("tc_chunk_after_cache", 4, 32, 8, 200, 1100, 120, True, 512, 0.0, "bfloat16", "bfloat16"),
    ("tc_no_visible_key", 1, 4, 2, 300, 100, 64, True, 0, 0.0, "bfloat16", "bfloat16"),
    ("tc_softcap_window", 1, 8, 4, 300, 300, 128, True, 64, 50.0, "bfloat16", "bfloat16"),
    ("tc_not_causal_window", 1, 4, 1, 150, 150, 64, False, 33, 0.0, "bfloat16", "bfloat16"),
    ("tc_hd8_g8_fewer_keys_than_a_tile", 1, 8, 1, 3, 40, 8, True, 0, 0.0, "bfloat16", "bfloat16"),
    ("tc_window_1", 1, 4, 2, 100, 100, 32, True, 1, 0.0, "bfloat16", "bfloat16"),
]


@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_cuda_kernel_matches_plain(cuda, case):
    name, b, h, kv, sq, skv, hd, causal, window, softcap, qdt, kvdt = case
    q, k, v = _qkv(len(name) * 7919 + sq, b, h, kv, sq, skv, hd)
    q = torch.from_numpy(q).to(cuda, getattr(torch, qdt))
    k, v = (torch.from_numpy(a).to(cuda, getattr(torch, kvdt)) for a in (k, v))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = ops.flash_attention.tensor_core_launches
    got = ops.flash_attention(q, k, v, **kw)
    want = tref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    tensor_cores = name.startswith("tc_") or name in ("danube_prefill_small", "gemma2_softcap",
                                                      "chunk_after_cache")
    assert ops.flash_attention.tensor_core_launches == before + tensor_cores
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


def test_cuda_model_layout_takes_tensor_cores(cuda):
    """h2o-danube's prefill as the model calls the kernel: q a (B, S, H, hd)
    projection scaled in bf16 (7,680-byte rows) and a (B, S_max, KV, hd)
    cache (1,920-byte rows) sliced and permuted, scale 1. Both calls go
    through the tensor-core kernel, give the same bits and keep q's layout."""
    b, s_max, kv, h, hd, s = 2, 640, 8, 32, 120, 600
    gen = torch.Generator(device=cuda).manual_seed(1)
    cache_k = torch.randn((b, s_max, kv, hd), generator=gen, device=cuda).bfloat16()
    cache_v = torch.randn((b, s_max, kv, hd), generator=gen, device=cuda).bfloat16()
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda).bfloat16()
    q = (q * torch.tensor(hd ** -0.5).bfloat16().item()).transpose(1, 2)
    k, v = cache_k[:, :s].transpose(1, 2), cache_v[:, :s].transpose(1, 2)
    tc, fma = ops.flash_attention.tensor_core_launches, ops.flash_attention.fma_launches
    got = ops.flash_attention(q, k, v, window=256, scale=1.0)
    again = ops.flash_attention(q, k, v, window=256, scale=1.0)
    want = tref.flash_attention_ref(q, k, v, window=256, scale=1.0)
    torch.cuda.synchronize()
    assert ops.flash_attention.tensor_core_launches == tc + 2
    assert ops.flash_attention.fma_launches == fma
    assert got.stride() == q.stride()
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


# (name, B, H, KV, Sq, Skv, hd, causal, window, softcap, layout): bf16 calls
# of the decode kernel. G = 1, 2, 4 (and 8 with Sq > 1), hd 8 to 256, the
# window's edge, softcap, ragged Skv, 16 packed rows in two blocks, rows
# with no visible key; most split the KV range over several blocks.
DECODE_CARD_CASES = [
    ("g4_hd120_window", 4, 32, 8, 1, 4640, 120, True, 4096, 0.0, "model"),
    ("g2_hd128_softcap_window", 4, 32, 16, 1, 2080, 128, True, 4096, 50.0, "model"),
    ("g1_hd80_causal", 4, 32, 32, 1, 2080, 80, True, 0, 0.0, "model"),
    ("g4_hd64_softcap_ragged", 3, 8, 2, 1, 1001, 64, True, 0, 30.0, "contiguous"),
    ("g2_hd120_window_short", 2, 4, 2, 1, 333, 120, True, 100, 0.0, "model"),
    ("g1_hd128_not_causal", 1, 4, 4, 1, 777, 128, False, 0, 0.0, "contiguous"),
    ("g4_sq4_rows16_window", 1, 4, 1, 4, 300, 64, True, 50, 0.0, "contiguous"),
    ("g2_sq3_window", 2, 8, 4, 3, 500, 80, True, 130, 0.0, "model"),
    ("g8_sq2_not_causal_window", 1, 8, 1, 2, 600, 120, False, 70, 0.0, "contiguous"),
    ("hd8_fewer_keys_than_a_step", 1, 8, 4, 1, 5, 8, True, 0, 0.0, "contiguous"),
    ("hd256", 1, 4, 2, 1, 900, 256, True, 0, 0.0, "contiguous"),
    ("no_visible_key", 1, 2, 2, 4, 3, 64, True, 0, 0.0, "contiguous"),
]


@pytest.mark.parametrize("case", DECODE_CARD_CASES, ids=[c[0] for c in DECODE_CARD_CASES])
def test_cuda_decode_kernel_matches_plain(cuda, case):
    """The decode kernel against its plain version (one bf16 ulp of each
    row's scale, 2^-11 relative RMS), two calls bit-equal, one decode launch
    each, the output in q's layout."""
    name, b, h, kv, sq, skv, hd, causal, window, softcap, kind = case
    qn, kn, vn = _qkv(len(name) * 104_729 + skv, b, h, kv, sq, skv, hd)
    if kind == "model":
        q = torch.from_numpy(qn).to(cuda, torch.bfloat16).transpose(1, 2).contiguous()
        q = q.transpose(1, 2)
        cache = torch.zeros((2, b, skv + 32, kv, hd), dtype=torch.bfloat16, device=cuda)
        cache[0, :, :skv] = torch.from_numpy(kn).to(cuda, torch.bfloat16).transpose(1, 2)
        cache[1, :, :skv] = torch.from_numpy(vn).to(cuda, torch.bfloat16).transpose(1, 2)
        k, v = cache[0, :, :skv].transpose(1, 2), cache[1, :, :skv].transpose(1, 2)
    else:
        q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (qn, kn, vn))
    assert decode_path(q, k, v)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = (ops.flash_attention.decode_launches, ops.flash_attention.launches)
    got = ops.flash_attention(q, k, v, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    want = tref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (ops.flash_attention.decode_launches, ops.flash_attention.launches) == (
        before[0] + 2, before[1] + 2)
    assert got.dtype == q.dtype and got.stride() == q.stride()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert _card_close(got, want), float((got.float() - want.float()).abs().max())

