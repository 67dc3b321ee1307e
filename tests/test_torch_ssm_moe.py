"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) and
mixture-of-experts FFN (``repro_torch.models.moe``): ``tests/test_ssm_moe.py``
mirrored torch against torch, and each function against the JAX package's
on the same numpy inputs (JAX under ``jax.jit``; block weights from the
reference's ``init_params`` carried by ``repro_torch.convert``).

Tolerances: float32 throughout. The chunked SSD against the sequential one
as the reference holds its own (2e-4; 5e-4 over random seeds and chunks:
the chunked form sums decays in another order). Against JAX 2e-5 for the
SSD core and 1e-4 for the blocks (the same float32 algorithm, summed in
another order; the block adds two projections and an RMSNorm). The MoE
output against JAX within 1e-5 with the same expert ids, dropped share and
router entropy (to float32 rounding), and against the dense oracle within
1e-4 as the reference holds its own.

The chunk-256 case: with the decay over a chunk past 88, the reference's
``exp`` above the diagonal overflows and ``jax.grad`` of its
``ssd_chunked`` is NaN in ``dt``; the port masks before ``exp``, so its
gradients are finite and equal autograd through ``ssd_sequential``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm

SSD_TOL = dict(rtol=2e-4, atol=2e-4)
JAX_SSD_TOL = dict(rtol=2e-5, atol=2e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ssd_inputs(seed, b, s, h, p, n, dt_shift=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - dt_shift)).astype(np.float32)
    a_neg = -np.exp(0.3 * rng.standard_normal((h,))).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) / np.sqrt(n)).astype(np.float32)
    d = np.full((h,), 0.5, np.float32)
    return x, dt, a_neg, bm, cm, d


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _np(t):
    return t.detach().numpy()


class TestSSD:
    @pytest.mark.parametrize("chunk", [4, 8, 16, 32])
    def test_chunked_matches_sequential(self, chunk):
        inputs = _t(_ssd_inputs(0, 2, 32, 3, 8, 4))
        y_ref, s_ref = tssm.ssd_sequential(*inputs)
        y, s = tssm.ssd_chunked(*inputs, chunk)
        np.testing.assert_allclose(_np(y), _np(y_ref), **SSD_TOL)
        np.testing.assert_allclose(_np(s), _np(s_ref), **SSD_TOL)

    def test_initial_state_continuation(self):
        """Chunked over [0:16] then [16:32] with the carried state == one
        pass."""
        x, dt, a, bm, cm, d = _t(_ssd_inputs(1, 1, 32, 2, 4, 4))
        y_ref, s_ref = tssm.ssd_sequential(x, dt, a, bm, cm, d)
        y1, s1 = tssm.ssd_chunked(x[:, :16], dt[:, :16], a, bm[:, :16], cm[:, :16], d, 8)
        y2, s2 = tssm.ssd_chunked(x[:, 16:], dt[:, 16:], a, bm[:, 16:], cm[:, 16:], d, 8,
                                  initial_state=s1)
        np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_ref), **SSD_TOL)
        np.testing.assert_allclose(_np(s2), _np(s_ref), **SSD_TOL)

    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(0, 1000), chunk=st.sampled_from([2, 4, 8]))
    def test_property_chunked_equals_sequential(self, seed, chunk):
        inputs = _t(_ssd_inputs(seed, 1, 16, 2, 4, 3))
        y_ref, _ = tssm.ssd_sequential(*inputs)
        y, _ = tssm.ssd_chunked(*inputs, chunk)
        np.testing.assert_allclose(_np(y), _np(y_ref), rtol=5e-4, atol=5e-4)

    @pytest.mark.parametrize("s,chunk,with_state", [(32, 8, False), (29, 8, False),
                                                    (13, 4, True)])
    def test_chunked_matches_jax(self, s, chunk, with_state):
        """The port's ``ssd_chunked`` against the reference's, a padded tail
        (29 and 13 are not multiples of the chunk) and a carried state
        included."""
        x, dt, a, bm, cm, d = _ssd_inputs(2, 2, s, 3, 8, 4)
        init = (np.random.default_rng(9).standard_normal((2, 3, 4, 8)).astype(np.float32)
                if with_state else None)
        yj, sj = jax.jit(functools.partial(jssm.ssd_chunked, chunk=chunk))(
            x, dt, a, bm, cm, d, initial_state=init)
        yt, st_ = tssm.ssd_chunked(*_t((x, dt, a, bm, cm, d)), chunk,
                                   initial_state=None if init is None else torch.from_numpy(init))
        np.testing.assert_allclose(_np(yt), np.asarray(yj), **JAX_SSD_TOL)
        np.testing.assert_allclose(_np(st_), np.asarray(sj), **JAX_SSD_TOL)

    def test_chunk_256_gradients_finite(self):
        """At the real chunk of 256 the decay over a chunk passes 88: the
        reference's gradient in ``dt`` is NaN, the port's ``dt`` and ``x``
        gradients are finite and equal autograd through the sequential
        form."""
        x, dt, a, bm, cm, d = _ssd_inputs(0, 1, 512, 2, 4, 4, dt_shift=0.5)
        assert (dt * -a).reshape(1, 2, 256, 2).sum(2).min() > 88.0
        _, gdt_j = jax.jit(jax.grad(
            lambda x_, dt_: jssm.ssd_chunked(x_, dt_, a, bm, cm, d, 256)[0].sum(),
            argnums=(0, 1)))(x, dt)
        assert np.isnan(np.asarray(gdt_j)).any()

        def grads(fn):
            xt = torch.from_numpy(x).requires_grad_()
            dtt = torch.from_numpy(dt).requires_grad_()
            y, _ = fn(xt, dtt, *_t((a, bm, cm, d)))
            return torch.autograd.grad(y.sum(), (xt, dtt))

        gx, gdt = grads(lambda *args: tssm.ssd_chunked(*args, 256))
        gx_ref, gdt_ref = grads(tssm.ssd_sequential)
        assert torch.isfinite(gx).all() and torch.isfinite(gdt).all()
        np.testing.assert_allclose(_np(gdt), _np(gdt_ref), **SSD_TOL)
        np.testing.assert_allclose(_np(gx), _np(gx_ref), **SSD_TOL)


@functools.lru_cache(maxsize=None)
def _layer0(arch, **over):
    """(JAX config, port config, the reference's layer-0 params, the port's
    copy), float32."""
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), dtype="float32", **over)
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), dtype="float32", **over)
    params = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, tcfg, jax.tree.map(lambda a: a[0], params["layers"]), tparams["layers"][0]


class TestSSMBlock:
    def test_decode_step_matches_sequential(self):
        """Decode steps of ``ssm_block`` reproduce the train-mode forward."""
        _, cfg, _, lp = _layer0("mamba2-370m")
        b, s = 2, 8
        x = torch.from_numpy(
            0.5 * np.random.default_rng(1).standard_normal((b, s, cfg.d_model)).astype(np.float32))
        y_train, _ = tssm.ssm_block(lp["ssm"], cfg, x)
        cache = tssm.init_ssm_cache(cfg, b, device="cpu")
        ys = []
        for t in range(s):
            y_t, cache = tssm.ssm_block(lp["ssm"], cfg, x[:, t:t + 1], cache=cache, decode=True)
            ys.append(y_t)
        np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(y_train), rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
    @pytest.mark.parametrize("s", [2, 11])
    def test_block_matches_jax(self, arch, s):
        """Prefill from a fresh cache (a prompt of 2 is shorter than the conv
        window: its conv state is left-padded with zeros), then three decode
        steps: outputs and both cache leaves against the reference's."""
        jcfg, tcfg, jlp, tlp = _layer0(arch)
        rng = np.random.default_rng(s)
        x = (0.5 * rng.standard_normal((2, s + 3, tcfg.d_model))).astype(np.float32)
        jblock = jax.jit(functools.partial(jssm.ssm_block, cfg=jcfg), static_argnames="decode")
        jcache = jssm.init_ssm_cache(jcfg, 2)
        tcache = tssm.init_ssm_cache(tcfg, 2, device="cpu")
        for lo, hi in [(0, s), (s, s + 1), (s + 1, s + 2), (s + 2, s + 3)]:
            decode = lo > 0
            yj, jcache = jblock(jlp["ssm"], x=x[:, lo:hi], cache=jcache, decode=decode)
            yt, tcache = tssm.ssm_block(tlp["ssm"], tcfg, torch.from_numpy(x[:, lo:hi]),
                                        cache=tcache, decode=decode)
            np.testing.assert_allclose(_np(yt), np.asarray(yj), **BLOCK_TOL)
            for got, want in zip(tcache, jcache):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(_np(got), np.asarray(want), **BLOCK_TOL)


def _moe_x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


class TestMoE:
    def test_dispatch_matches_dense_oracle(self):
        """With generous capacity nothing drops; gather path == oracle."""
        _, cfg, _, lp = _layer0("deepseek-moe-16b", capacity_factor=8.0)
        x = torch.from_numpy(_moe_x(1, 2, 16, cfg.d_model))
        y, metrics = tmoe.moe_ffn(lp["moe"], cfg, x)
        assert float(metrics["moe_dropped_frac"]) == 0.0
        np.testing.assert_allclose(_np(y), _np(tmoe.moe_ffn_dense_oracle(lp["moe"], cfg, x)),
                                   rtol=1e-4, atol=1e-4)

    def test_mixtral_router_convention(self):
        _, cfg, _, lp = _layer0("mixtral-8x22b", capacity_factor=8.0)
        x = torch.from_numpy(_moe_x(3, 2, 8, cfg.d_model))
        y, _ = tmoe.moe_ffn(lp["moe"], cfg, x)
        np.testing.assert_allclose(_np(y), _np(tmoe.moe_ffn_dense_oracle(lp["moe"], cfg, x)),
                                   rtol=1e-4, atol=1e-4)

    def test_capacity_drops_are_counted(self):
        _, cfg, _, lp = _layer0("deepseek-moe-16b", capacity_factor=0.25)
        y, metrics = tmoe.moe_ffn(lp["moe"], cfg, torch.from_numpy(_moe_x(5, 2, 32, cfg.d_model)))
        assert float(metrics["moe_dropped_frac"]) > 0.0
        assert torch.isfinite(y).all()

    def test_grads_flow(self):
        _, cfg, _, lp = _layer0("deepseek-moe-16b", capacity_factor=4.0)
        params = {k: (v if isinstance(v, dict) else v.clone().requires_grad_())
                  for k, v in lp["moe"].items()}
        y, _ = tmoe.moe_ffn(params, cfg, torch.from_numpy(_moe_x(7, 1, 8, cfg.d_model)))
        g_router, g_gate = torch.autograd.grad((y ** 2).sum(),
                                               (params["router"], params["w_gate"]))
        assert float(g_router.abs().sum()) > 0 and float(g_gate.abs().sum()) > 0

    @pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b"])
    @pytest.mark.parametrize("cf", [1.25, 0.25])
    def test_matches_jax(self, arch, cf):
        """The capacity dispatch against the reference's at the real
        capacity factor 1.25 and at 0.25 (drops in every row): the same
        expert ids, output, dropped share and router entropy."""
        jcfg, tcfg, jlp, tlp = _layer0(arch, capacity_factor=cf)
        x = _moe_x(11, 3, 24, tcfg.d_model)
        _, jidx, _ = jax.jit(functools.partial(jmoe._route, jcfg))(jlp["moe"], x)
        _, tidx, _ = tmoe._route(tcfg, tlp["moe"], torch.from_numpy(x))
        np.testing.assert_array_equal(_np(tidx), np.asarray(jidx))
        yj, mj = jax.jit(functools.partial(jmoe.moe_ffn, cfg=jcfg))(jlp["moe"], x=x)
        yt, mt = tmoe.moe_ffn(tlp["moe"], tcfg, torch.from_numpy(x))
        np.testing.assert_allclose(_np(yt), np.asarray(yj), **MOE_TOL)
        assert set(mt) == set(mj)
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-6, atol=1e-7)
        if cf < 1.0:
            assert float(mt["moe_dropped_frac"]) > 0.0

    def test_oracle_matches_jax(self):
        jcfg, tcfg, jlp, tlp = _layer0("deepseek-moe-16b")
        x = _moe_x(13, 2, 8, tcfg.d_model)
        yj = jax.jit(functools.partial(jmoe.moe_ffn_dense_oracle, cfg=jcfg))(jlp["moe"], x=x)
        yt = tmoe.moe_ffn_dense_oracle(tlp["moe"], tcfg, torch.from_numpy(x))
        np.testing.assert_allclose(_np(yt), np.asarray(yj), **MOE_TOL)

    def test_two_calls_bit_equal_and_padding_invisible(self):
        """The combine gathers in choice order: two calls give the same
        bits. A row right-padded with zeros keeps its real tokens' slots
        (the stable sort puts padding after them) when the padded row's
        capacity leaves nothing to drop."""
        _, cfg, _, lp = _layer0("deepseek-moe-16b", capacity_factor=8.0)
        x = torch.from_numpy(_moe_x(17, 2, 12, cfg.d_model))
        y1, m1 = tmoe.moe_ffn(lp["moe"], cfg, x)
        y2, m2 = tmoe.moe_ffn(lp["moe"], cfg, x)
        assert torch.equal(y1, y2) and all(torch.equal(m1[k], m2[k]) for k in m1)
        padded = torch.cat([x, torch.zeros((2, 4, cfg.d_model))], dim=1)
        yp, _ = tmoe.moe_ffn(lp["moe"], cfg, padded)
        np.testing.assert_allclose(_np(yp[:, :12]), _np(y1), rtol=1e-6, atol=1e-6)
