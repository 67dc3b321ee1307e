"""The port's sampled-head loss (repro_torch.kernels.sampled_loss) against the
JAX package's plain references, and, on a card, the CUDA kernel against its
plain version.

The JAX side is ``repro.kernels.sampled_loss.loss_and_coeffs`` and
``repro.kernels.ref.sampled_head_loss_ref``, jit-compiled on the CPU; the
Pallas ``sampled_head_loss`` cannot run on the installed JAX and is not the
reference. Inputs are made from a seed with numpy and given to both
packages. Tolerance: float32, 1e-5 absolute + 1e-5 relative for scores,
losses, coefficients and dh. On the card, dh, a sum of m products whose
coefficients reach (C-1)/n for OVE, is held within 1e-5 of the magnitude of
its terms, sum_j |coeff_j| |w_j|, as a float32 sum is.

The ``test_cuda_*`` tests need an NVIDIA card and skip elsewhere; they do not
import JAX. On a card, from the root of a checkout:
    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest -k cuda tests/test_torch_sampled_loss.py
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sampled_loss as sl
from repro_torch.kernels.sampled_loss import SAMPLED_KINDS, loss_and_coeffs

TOL = dict(atol=1e-5, rtol=1e-5)
REG_SOFTCAP = [(0.0, 0.0), (1e-2, 25.0)]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's references, imported only by the tests that
    compare against them (the card tests run where JAX is absent)."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels import sampled_loss as jsl

    @functools.lru_cache(maxsize=None)
    def jitted(fn, **kw):
        return jax.jit(functools.partial(fn, **kw))

    return dict(jnp=jnp, jitted=jitted, loss_and_coeffs=jsl.loss_and_coeffs,
                ref=jref.sampled_head_loss_ref, kinds=jsl.SAMPLED_KINDS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _score_inputs(seed, t, m, id_range):
    """Raw scores, noise log-probs, ids and the accidental-hit mask; a small
    ``id_range`` forces negatives equal to the positive."""
    rng = np.random.default_rng(seed)
    scores = (3.0 * rng.standard_normal((t, m))).astype(np.float32)
    lp = (-np.abs(rng.standard_normal((t, m)))).astype(np.float32)
    ids = rng.integers(0, id_range, (t, m))
    hit = ids == ids[:, :1]
    hit[:, 0] = False
    return scores, lp, ids, hit


def _head_inputs(seed, c, kdim, t, m, w_scale=0.5):
    rng = np.random.default_rng(seed)
    w = (w_scale * rng.standard_normal((c, kdim))).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    h = rng.standard_normal((t, kdim)).astype(np.float32)
    ids = rng.integers(0, c, (t, m))
    ids[::3, 1] = ids[::3, 0]              # accidental hits on every third token
    lp = (-np.abs(rng.standard_normal((t, m))) - 2.0).astype(np.float32)
    return w, b, h, ids, lp


def test_sampled_kinds_match_jax(jax_side):
    assert SAMPLED_KINDS == jax_side["kinds"]


# ---------------------------------------------------------------------------
# The per-kind math against the JAX package, and against torch.autograd.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("reg,softcap", REG_SOFTCAP, ids=["plain", "reg_softcap"])
@pytest.mark.parametrize("kind", SAMPLED_KINDS)
def test_loss_and_coeffs_match_jax(jax_side, kind, reg, softcap, mask):
    jnp = jax_side["jnp"]
    scores, lp, ids, hit = _score_inputs(3, 17, 4, 5)
    assert hit.any()
    kw = dict(kind=kind, num_labels=40, reg=reg, softcap=softcap,
              mask_accidental=mask)
    want = jax_side["jitted"](jax_side["loss_and_coeffs"], **kw)(
        jnp.asarray(scores), jnp.asarray(lp), jnp.asarray(hit))
    got = loss_and_coeffs(torch.from_numpy(scores), torch.from_numpy(lp),
                          torch.from_numpy(hit), **kw)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)


@pytest.mark.parametrize("reg,softcap", REG_SOFTCAP, ids=["plain", "reg_softcap"])
@pytest.mark.parametrize("kind", SAMPLED_KINDS)
def test_coeff_is_autograd_of_the_loss(kind, reg, softcap):
    scores, lp, _, hit = _score_inputs(5, 17, 4, 5)
    s = torch.from_numpy(scores).requires_grad_()
    kw = dict(kind=kind, num_labels=40, reg=reg, softcap=softcap)
    loss_vec, coeff, _ = loss_and_coeffs(s, torch.from_numpy(lp),
                                         torch.from_numpy(hit), **kw)
    (want,) = torch.autograd.grad(loss_vec.sum(), s)
    torch.testing.assert_close(coeff.detach(), want, rtol=1e-5, atol=1e-6)


def test_unknown_kind_raises():
    scores, lp, _, hit = (torch.from_numpy(a) for a in _score_inputs(0, 3, 2, 5))
    with pytest.raises(ValueError, match="no sampled candidate loss"):
        loss_and_coeffs(scores, lp, hit, kind="softmax", num_labels=5)


# ---------------------------------------------------------------------------
# The wrapper on the CPU (its plain version) against the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_neg,t", [(1, 7), (4, 37), (16, 150)])
@pytest.mark.parametrize("kind", SAMPLED_KINDS)
def test_sampled_head_loss_cpu_matches_jax_ref(jax_side, kind, n_neg, dtype, t):
    jnp = jax_side["jnp"]
    c, kdim = 300, 64
    w, b, h, ids, lp = _head_inputs(t + n_neg, c, kdim, t, 1 + n_neg)
    kw = dict(kind=kind, num_labels=c, reg=1e-3, softcap=0.0, mask_accidental=True)
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(w).to(tdt), torch.from_numpy(b).to(tdt),
            torch.from_numpy(h), torch.from_numpy(ids), torch.from_numpy(lp))
    # Both read tables as float32 values, so the JAX side takes the table's
    # values as float32 (one compile for both dtypes).
    want = jax_side["jitted"](jax_side["ref"], **kw)(
        jnp.asarray(args[0].float().numpy()), jnp.asarray(args[1].float().numpy()),
        jnp.asarray(h), jnp.asarray(ids, jnp.int32), jnp.asarray(lp))
    before = ops.sampled_head_loss.launches
    got = ops.sampled_head_loss(*args, **kw)
    assert ops.sampled_head_loss.launches == before    # the plain version ran
    shapes = [(t,), (t, 1 + n_neg), (t, 1 + n_neg), (t, kdim)]
    for g, w_, shape in zip(got, want, shapes):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)


@pytest.mark.parametrize("bad", ["one_slot", "int32_ids", "float64_h", "lp_shape",
                                 "bias_dtype", "strided_ids", "kind"])
def test_sampled_head_loss_rejects_what_the_kernel_does_not_take(bad):
    w, b, h, ids, lp = (torch.from_numpy(a) for a in _head_inputs(0, 50, 16, 7, 3))
    kind = "adversarial_ns"
    if bad == "one_slot":
        ids, lp = ids[:, :1].contiguous(), lp[:, :1].contiguous()
    elif bad == "int32_ids":
        ids = ids.int()
    elif bad == "float64_h":
        h = h.double()
    elif bad == "lp_shape":
        lp = lp[:, :2].contiguous()
    elif bad == "bias_dtype":
        b = b.bfloat16()
    elif bad == "strided_ids":
        ids = torch.cat([ids, ids], dim=1)[:, ::2]
    else:
        kind = "softmax"
    with pytest.raises((TypeError, ValueError)):
        ops.sampled_head_loss(w, b, h, ids, lp, kind=kind, num_labels=50)


@pytest.mark.parametrize("m,k,itemsize,want", [
    (2, 512, 4, 2),          # the training shape: everything staged
    (17, 512, 4, 17),
    (17, 512, 2, 17),
    (512, 512, 4, 106),      # 1 MB of rows: five chunks
    (512, 512, 2, 213),
    (512, 130, 4, 422),
    (17, 4096, 4, 13),       # 16 KB rows: two chunks
    (17, 4096, 2, 17),
    (512, 4096, 4, 12),
])
def test_staged_slots(m, k, itemsize, want):
    assert sl.staged_slots(m, k, itemsize) == want


def test_staged_slots_fill_but_never_pass_a_blocks_shared_memory():
    def smem(chunk, m, k, itemsize):
        r16 = sl._round16
        return r16(chunk * k * itemsize) + r16(4 * k) + r16(8 * m) + 4 * r16(4 * m)

    for m in (2, 3, 10, 11, 17, 64, 511, 512):
        for k in (1, 3, 50, 130, 511, 512, 3840, 4095, 4096):
            for itemsize in (2, 4):
                chunk = sl.staged_slots(m, k, itemsize)
                assert 1 <= chunk <= m
                assert smem(chunk, m, k, itemsize) <= sl._MAX_SMEM_BYTES
                assert chunk == m or smem(chunk + 1, m, k, itemsize) > sl._MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# On a card: the kernel against its plain version.
# ---------------------------------------------------------------------------

def _dh_close(got, want, coeff, w, ids):
    """dh within 1e-5 of the magnitude of its terms, sum_j |coeff_j| |w_j|."""
    scale = torch.einsum("tn,tnk->tk", coeff.abs(), w[ids].float().abs())
    return bool(((got - want).abs() <= 1e-5 + 1e-5 * scale).all())


@pytest.mark.parametrize("reg,softcap", REG_SOFTCAP, ids=["plain", "reg_softcap"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,m,kdim", [(7, 5, 50), (256, 2, 512), (2048, 17, 512),
                                     (37, 10, 510), (37, 11, 511), (9, 17, 4096),
                                     (19, 512, 130), (11, 512, 512)],
                         ids=["small_ragged", "main_path", "wide_unstaged", "m10_k510",
                              "m11_k511", "m17_k4096_chunked_fp32", "m512_k130_unaligned",
                              "m512_k512_chunked"])
@pytest.mark.parametrize("kind", SAMPLED_KINDS)
def test_cuda_sampled_head_loss_kernel_matches_plain(cuda, kind, t, m, kdim, dtype,
                                                     reg, softcap):
    c = 50_000
    w, b, h, ids, lp = (torch.from_numpy(a).to(cuda)
                        for a in _head_inputs(t + m + kdim, c, kdim, t, m, w_scale=0.05))
    w, b = w.to(dtype), b.to(dtype)
    kw = dict(kind=kind, num_labels=c, reg=reg, softcap=softcap, mask_accidental=True)
    before = ops.sampled_head_loss.launches
    got = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
    torch.cuda.synchronize()
    assert ops.sampled_head_loss.launches == before + 1
    want = tref.sampled_head_loss_ref(w, b, h, ids, lp, **kw)
    for g, w_ in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w_, **TOL)
    assert _dh_close(got[3], want[3], want[1], w, ids)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,m,kdim", [(256, 2, 512), (2048, 17, 512), (11, 512, 512),
                                     (9, 17, 4095)])
def test_cuda_sampled_head_loss_two_calls_bit_equal(cuda, t, m, kdim, dtype):
    w, b, h, ids, lp = (torch.from_numpy(a).to(cuda)
                        for a in _head_inputs(t + m, 5000, kdim, t, m, w_scale=0.05))
    w, b = w.to(dtype), b.to(dtype)
    kw = dict(kind="sampled_softmax", num_labels=5000, reg=1e-3)
    first = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
    second = ops.sampled_head_loss(w, b, h, ids, lp, **kw)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


def test_cuda_sampled_head_loss_entry_refuses_a_chunk_that_does_not_fit(cuda, monkeypatch):
    """The C entry checks the staged slots again."""
    w, b, h, ids, lp = (torch.from_numpy(a).to(cuda) for a in _head_inputs(2, 100, 4096, 4, 17))
    monkeypatch.setattr(sl, "staged_slots", lambda m, k, itemsize: m)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.sampled_head_loss(w, b, h, ids, lp, kind="adversarial_ns", num_labels=100)


def test_cuda_sampled_head_loss_out_of_range_id_is_nan(cuda):
    w, b, h, ids, lp = (torch.from_numpy(a).to(cuda) for a in _head_inputs(1, 100, 32, 4, 3))
    ids[1, 2] = 100
    ids[2, 0] = -1
    loss, coeff, xi, dh = (o.cpu() for o in ops.sampled_head_loss(
        w, b, h, ids, lp, kind="adversarial_ns", num_labels=100))
    for row in (1, 2):
        assert torch.isnan(loss[row]) and torch.isnan(coeff[row]).all()
        assert torch.isnan(xi[row]).all() and torch.isnan(dh[row]).all()
    assert torch.isfinite(loss[[0, 3]]).all() and torch.isfinite(dh[[0, 3]]).all()


@pytest.mark.parametrize("kind", ["adversarial_ns", "sampled_softmax"])
def test_cuda_sparse_step_matches_cpu(cuda, kind):
    """One sparse training step (kernel, dedupe, in-place Adagrad rows) on the
    card against the same step on the CPU, on the same candidates."""
    from repro_torch.core import heads
    from repro_torch.optim import OptimizerConfig, apply_updates, init_opt_state

    c, kdim, t = 500, 64, 96
    w, b, h, ids, lp = (torch.from_numpy(a) for a in _head_inputs(11, c, kdim, t, 3))
    cfg = heads.HeadConfig(num_labels=c, kind=kind, n_neg=2, reg=1e-3)
    # A non-zero accumulator keeps Adagrad's first step from amplifying
    # float32 noise where |g| is near eps.
    opt = OptimizerConfig(name="adagrad", learning_rate=0.05, adagrad_init=0.1)
    out = []
    for dev in ("cpu", cuda):
        # Copies: the sparse step writes its rows in place.
        params = heads.HeadParams(w.to(dev, copy=True), b.to(dev, copy=True))
        state = init_opt_state(opt, params)
        before = ops.sampled_head_loss.launches
        loss, _, grads, dh = heads.sparse_candidate_loss(cfg, params, h.to(dev), ids.to(dev),
                                                         lp.to(dev))
        params, state, _ = apply_updates(opt, params, grads, state)
        assert ops.sampled_head_loss.launches == before + (dev != "cpu")
        out.append([x.cpu() for x in (loss, dh, params.w, params.b, state.nu.w)])
    for got, want in zip(out[1], out[0]):
        torch.testing.assert_close(got, want, **TOL)
