"""The port's continuous-batching engine (``repro_torch.serve``) and its
paged steps, against the JAX package and against the port's own lock-step
decode.

Against JAX, on numpy inputs from a seed with the reference's weights
carried by ``repro_torch.convert`` (a config built like
``tests/test_serve_engine.py``'s, with two layers, GQA and a window):
``make_batched_prefill``, ``make_paged_decode`` and ``make_paged_prefill``
give the reference's hiddens and arena pages within 2e-4 in float32 and
6e-2 in bfloat16 (the tolerances of ``tests/test_torch_lm.py``: float32
sums in another order; bf16 rounded at every matmul, and the reference
rounds the attention probabilities to bf16 where the port keeps float32);
the per-row (slotted) decode branch matches the reference's; and one
small mixed trace gives the same tokens from the port's ``Engine`` as from
``repro.serve.Engine``.

Torch against torch (token ids equal, as the engine's outputs are a pure
function of the prompt): ``tests/test_serve_engine.py``'s scheduler
invariants, geometry oracle, fragmentation, candidate-cache and retirement
cases, mirrored case for case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st
from _torch_serve_common import (BEAM, CFG, HCFG, HEAD_STATE, MAX_LEN, N_SLOTS, PARAMS,
                                 lockstep, one_thread, prompts, shared_engine)  # noqa: F401

from repro.models import lm_head as jlm_head
from repro.models import transformer as jtransformer
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.models import lm_head, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.serve import Engine, Request, ServeConfig, TrafficConfig, drive, make_workload
from repro_torch.train import step as tstep

F32_TOL = dict(atol=2e-4, rtol=2e-4)
BF16_TOL = dict(atol=6e-2, rtol=6e-2)
PARITY = dict(name="engine-parity", num_layers=2, d_model=32, d_ff=64, vocab_size=100,
              num_heads=4, num_kv_heads=2, vocab_pad_multiple=128, gen_feature_dim=8,
              dtype="float32", remat=False, window_size=5)


def _carried(dtype):
    kw = dict(PARITY, dtype=dtype)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    params = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    state = jlm_head.default_head_state(jax.random.PRNGKey(1), jcfg, "adversarial_ns")
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tstate = convert.lm_head_state_from_numpy(
        np.asarray(state.proj), [np.asarray(a) for a in state.gen.tree], device="cpu")
    return jcfg, tcfg, params, state, tparams, tstate


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_steps_match_reference(dtype):
    """Batched prefill of two padded prompts into out-of-order pages, a
    paged decode with a free lane on the sink, then a multi-token paged step
    whose padding writes to the sink and whose second row runs past its
    reservation (the clamped page): hiddens of the real positions and the
    arena's mapped pages match the reference."""
    jcfg, tcfg, params, _, tparams, _ = _carried(dtype)
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    page_len, n_phys = 3, 12
    sink = n_phys - 1
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 100, (2, 8)).astype(np.int32)
    lengths = np.array([7, 5], np.int32)
    tables = np.array([[5, 2, 7, 9], [0, 3, sink, sink]], np.int32)
    jarena = jtransformer.init_paged_cache(jcfg, 2, n_phys, page_len, dtype=cdt)
    tarena = transformer.init_paged_cache(tcfg, 2, n_phys, page_len, dtype=tdt, device="cpu")
    mapped = [5, 2, 7, 9, 0, 3]

    def arena_close():
        for key in ("k", "v"):
            np.testing.assert_allclose(tarena[key][:, mapped].float().numpy(),
                                       _f32(jarena[key][:, mapped]), **tol)

    jh, jarena = jax.jit(jstep.make_batched_prefill(jcfg, page_len, sink, cache_dtype=cdt))(
        params, tokens, lengths, np.array([0, 1], np.int32), jarena, tables)
    th, tarena = tstep.make_batched_prefill(tcfg, page_len, sink, cache_dtype=tdt)(
        tparams, tokens, lengths, np.array([0, 1], np.int32), tarena, tables)
    for b in range(2):
        np.testing.assert_allclose(th[b, :lengths[b]].float().numpy(),
                                   _f32(jh[b, :lengths[b]]), **tol)
    arena_close()

    # Decode: row 1 is a free lane (all-sink table, position 0).
    token = rng.integers(0, 100, (2, 1)).astype(np.int32)
    pos = np.array([7, 0], np.int32)
    dtab = tables.copy()
    dtab[1] = sink
    jh, jarena = jax.jit(jstep.make_paged_decode(jcfg))(params, token, jarena, pos, dtab)
    th, tarena = tstep.make_paged_decode(tcfg)(tparams, token, tarena, pos, dtab)
    np.testing.assert_allclose(th[0].float().numpy(), _f32(jh[0]), **tol)
    arena_close()

    # Multi-token step: row 0 writes 2 of 4 positions (10, 11); its padding
    # positions 12 and 13 lie past its 4-page table (the page index clamps,
    # the write goes to the sink). Row 1 writes positions 5..8 into a third
    # page it has just been given.
    tokens = rng.integers(0, 100, (2, 4)).astype(np.int32)
    start, lens = np.array([10, 5], np.int32), np.array([2, 4], np.int32)
    mtab = np.array([[5, 2, 7, 9], [0, 3, 4, sink]], np.int32)
    mapped.append(4)
    jh, jarena = jax.jit(jstep.make_paged_prefill(jcfg))(params, tokens, start, lens, jarena,
                                                          mtab)
    th, tarena = tstep.make_paged_prefill(tcfg)(tparams, tokens, start, lens, tarena, mtab)
    for b in range(2):
        np.testing.assert_allclose(th[b, :lens[b]].float().numpy(), _f32(jh[b, :lens[b]]),
                                   **tol)
    arena_close()


def test_slotted_decode_matches_reference():
    """The per-row ``cache_pos`` branch (S = 1, a contiguous (B, S_max)
    cache): each row writes and attends at its own depth, as the
    reference's slotted decode."""
    jcfg, tcfg, params, _, tparams, _ = _carried("float32")
    rng = np.random.default_rng(9)
    cache = rng.normal(size=(2, 3, 10, 2, 8)).astype(np.float32)
    jcache = {"k": jnp.asarray(cache[0]), "v": jnp.asarray(cache[1])}
    tcache = {"k": torch.from_numpy(cache[0].copy()), "v": torch.from_numpy(cache[1].copy())}
    jcache = {k: jnp.broadcast_to(v[None], (2,) + v.shape) for k, v in jcache.items()}
    tcache = {k: v[None].expand(2, *v.shape).contiguous() for k, v in tcache.items()}
    token = rng.integers(0, 100, (3, 1)).astype(np.int32)
    pos = np.array([4, 0, 9], np.int32)
    jh, jnew, _ = jax.jit(lambda p, c: jtransformer.forward(
        p, jcfg, jnp.asarray(token), cache=c, cache_pos=jnp.asarray(pos)))(params, jcache)
    th, tnew, _ = transformer.forward(tparams, tcfg, torch.from_numpy(token), cache=tcache,
                                      cache_pos=pos)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tnew[key].numpy(), np.asarray(jnew[key]), **F32_TOL)


@pytest.mark.parametrize("beam", [0, 8])
def test_engine_matches_reference_engine(beam):
    """One small mixed trace (lengths 2..6, budgets 1..4, 2 lanes, page
    length 3, an undersized pool) through the reference's engine and the
    port's, on the same weights: the same tokens for every request."""
    jcfg, tcfg, params, state, tparams, tstate = _carried("float32")
    tc = dict(n_requests=6, rate=500.0, prompt_len=4, gen_tokens=2,
              prompt_len_choices=(2, 4, 6), gen_tokens_choices=(1, 3, 4), vocab_size=100,
              seed=3)
    kw = dict(n_slots=2, max_len=MAX_LEN, beam=beam, page_len=3, n_pages=6)
    jeng = JEngine(jcfg, jlm_head.head_config(jcfg, "adversarial_ns"), params, state,
                   JServeConfig(cache_dtype=jnp.float32, **kw))
    teng = Engine(tcfg, lm_head.head_config(tcfg, "adversarial_ns"), tparams, tstate,
                  ServeConfig(cache_dtype=torch.float32, **kw))
    work = make_workload(TrafficConfig(**tc))
    jh = [jeng.submit(JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens))
          for _, r in work]
    th = [teng.submit(Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens))
          for _, r in work]
    jeng.run()
    teng.run()
    for a, b in zip(th, jh):
        assert a.tokens == b.tokens
    assert list(teng.admission_order) == list(jeng.admission_order)
    assert teng.prefill_calls == jeng.prefill_calls
    assert teng.decode_steps == jeng.decode_steps
    teng.pool.check_invariants()


# --- mirrored from tests/test_serve_engine.py ----------------------------------

class TestSchedulerInvariants:
    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(0, 2**20), n=st.integers(1, 6), gen=st.integers(1, 4),
           use_eos=st.sampled_from([False, True]))
    def test_every_request_retires_exactly_once(self, seed, n, gen, use_eos):
        engine = shared_engine(page_len=3)
        rng = np.random.default_rng(seed)
        completed_before = len(engine.completed)
        handles = [engine.submit(Request(
            prompt=p, max_new_tokens=gen,
            eos_id=int(rng.integers(0, CFG.vocab_size)) if use_eos else None))
            for p in prompts(rng, n)]
        order_before = list(engine.admission_order)
        engine.run()
        new_completed = list(engine.completed)[completed_before:]
        assert sorted(h.request_id for h in new_completed) == \
            sorted(h.request_id for h in handles)
        for h in handles:
            assert h.done and h.finished_at is not None
            assert 1 <= len(h.tokens) <= gen
            if len(h.tokens) < gen:
                assert h.eos_hit
            assert all(0 <= t < CFG.vocab_size for t in h.tokens)
        engine.pool.check_invariants()
        assert engine.pool.num_free_lanes == N_SLOTS
        assert engine.pool.num_mapped_pages == 0
        assert engine.num_active == 0 and engine.num_pending == 0
        new_order = list(engine.admission_order)[len(order_before):]
        assert new_order == [h.request_id for h in handles]


class TestGeometryOracle:
    """Engine output equals the port's lock-step decode for every page
    geometry: paging changes physical addressing only."""

    @settings(max_examples=6, deadline=None)
    @given(seed=st.integers(0, 2**20))
    def test_byte_identical_to_lockstep_beam(self, seed):
        engine = shared_engine(page_len=3)
        rng = np.random.default_rng(seed)
        b, pl, gen = 3, 3, 3
        ps = rng.integers(0, CFG.vocab_size, (b, pl)).astype(np.int32)
        ref = lockstep(ps, gen, BEAM)
        handles = [engine.submit(Request(prompt=p, max_new_tokens=gen)) for p in ps]
        engine.run()
        np.testing.assert_array_equal(np.stack([h.result() for h in handles]), ref)

    @pytest.mark.parametrize("page_len", [1, MAX_LEN])
    @pytest.mark.parametrize("batched", [True, False])
    def test_geometry_sweep_beam(self, page_len, batched):
        self._run_geometry(page_len, batched, beam=BEAM)

    @pytest.mark.parametrize("page_len", [3, 7])
    @pytest.mark.parametrize("batched", [True, False])
    def test_geometry_sweep_beam_odd_pages(self, page_len, batched):
        self._run_geometry(page_len, batched, beam=BEAM)

    def _run_geometry(self, page_len, batched, beam):
        rng = np.random.default_rng(1000 * page_len + batched)
        b, gen = 4, 3
        ps = prompts(rng, b, lo=2, hi=5)
        refs = [lockstep(p[None], gen, beam)[0] for p in ps]
        engine = shared_engine(page_len=page_len, batched=batched)
        handles = [engine.submit(Request(prompt=p, max_new_tokens=gen)) for p in ps]
        engine.run()
        for h, ref in zip(handles, refs):
            np.testing.assert_array_equal(h.result(), ref)
        engine.pool.check_invariants()

    def test_byte_identical_to_lockstep_dense(self):
        rng = np.random.default_rng(7)
        b, pl, gen = 3, 3, 3
        ps = rng.integers(0, CFG.vocab_size, (b, pl)).astype(np.int32)
        ref = lockstep(ps, gen, 0)
        for page_len in (1, 3, MAX_LEN):
            eng = Engine(CFG, HCFG, PARAMS, HEAD_STATE, ServeConfig(
                n_slots=2, max_len=MAX_LEN, beam=0, page_len=page_len,
                cache_dtype=torch.float32))
            handles = [eng.submit(Request(prompt=p, max_new_tokens=gen)) for p in ps]
            eng.run()
            np.testing.assert_array_equal(np.stack([h.result() for h in handles]), ref)

    def test_batched_prefill_one_launch_for_burst(self):
        rng = np.random.default_rng(41)
        gen = 2
        ps = prompts(rng, N_SLOTS, lo=2, hi=4)
        refs = [lockstep(p[None], gen, BEAM)[0] for p in ps]
        for batched, expect_calls in ((True, 1), (False, N_SLOTS)):
            eng = Engine(CFG, HCFG, PARAMS, HEAD_STATE, ServeConfig(
                n_slots=N_SLOTS, max_len=MAX_LEN, beam=BEAM, page_len=3,
                batched_prefill=batched, cache_dtype=torch.float32))
            handles = [eng.submit(Request(prompt=p, max_new_tokens=gen)) for p in ps]
            eng.step()
            assert eng.prefill_calls == expect_calls
            eng.run()
            for h, ref in zip(handles, refs):
                np.testing.assert_array_equal(h.result(), ref)


class TestFragmentation:
    def test_half_size_paged_pool_serves_mixed_trace(self):
        page_len = 3
        n_pages = (N_SLOTS * MAX_LEN // 2) // page_len
        assert n_pages * page_len * 2 == N_SLOTS * MAX_LEN
        tcfg = TrafficConfig(
            n_requests=12, rate=500.0, prompt_len=4, gen_tokens=2,
            prompt_len_choices=(2, 3, 4), gen_tokens_choices=(1, 2, 3),
            vocab_size=CFG.vocab_size, seed=5)
        engine = Engine(CFG, HCFG, PARAMS, HEAD_STATE, ServeConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, beam=BEAM, page_len=page_len,
            n_pages=n_pages, cache_dtype=torch.float32))
        res = drive(engine, make_workload(tcfg), time_scale=0.0)
        assert res["n_requests"] == tcfg.n_requests
        stats = engine.stats()
        assert stats["completed"] >= tcfg.n_requests
        assert 0 < stats["peak_pages_in_use"] <= n_pages
        assert stats["pages_in_use"] == 0
        engine.pool.check_invariants()
        for h in list(engine.completed)[-tcfg.n_requests:]:
            ref = lockstep(h.request.prompt[None], h.request.max_new_tokens, BEAM)[0]
            np.testing.assert_array_equal(h.result(), ref)

    def test_internal_fragmentation_reported(self):
        engine = Engine(CFG, HCFG, PARAMS, HEAD_STATE, ServeConfig(
            n_slots=1, max_len=MAX_LEN, beam=0, page_len=MAX_LEN, cache_dtype=torch.float32))
        rng = np.random.default_rng(43)
        prompt = rng.integers(0, CFG.vocab_size, 2).astype(np.int32)
        engine.submit(Request(prompt=prompt, max_new_tokens=6))
        engine.step()
        frag = engine.stats()["internal_fragmentation"]
        assert 0.0 < frag < 1.0
        engine.run()
        assert engine.stats()["internal_fragmentation"] == 0.0


class TestCandidateCachePath:
    def test_repeat_prefix_hits_and_identical_outputs(self):
        engine = shared_engine(page_len=3)
        rng = np.random.default_rng(11)
        prompt = rng.integers(0, CFG.vocab_size, 4).astype(np.int32)
        h1 = engine.submit(Request(prompt=prompt, max_new_tokens=4))
        engine.run()
        skips_before = engine.descent_skips
        hits_before = engine.candidate_cache.hits
        h2 = engine.submit(Request(prompt=prompt, max_new_tokens=4))
        engine.run()
        assert h2.tokens == h1.tokens
        assert engine.candidate_cache.hits > hits_before
        assert engine.descent_skips > skips_before

    def test_head_swap_invalidates_cached_candidates(self):
        new_head = lm_head.default_head_state(torch.Generator().manual_seed(2), CFG,
                                              "adversarial_ns", device="cpu")

        def fresh(head_state):
            return Engine(CFG, HCFG, PARAMS, head_state, ServeConfig(
                n_slots=1, max_len=MAX_LEN, beam=BEAM, page_len=3, cache_dtype=torch.float32))

        rng = np.random.default_rng(19)
        prompt = rng.integers(0, CFG.vocab_size, 4).astype(np.int32)
        eng = fresh(HEAD_STATE)
        eng.submit(Request(prompt=prompt, max_new_tokens=4))
        eng.run()
        skips0 = eng.descent_skips
        eng.submit(Request(prompt=prompt, max_new_tokens=4))
        eng.run()
        assert eng.descent_skips > skips0
        eng.swap_head_state(new_head)
        skips1 = eng.descent_skips
        h = eng.submit(Request(prompt=prompt, max_new_tokens=4))
        eng.run()
        assert eng.descent_skips == skips1
        stats = eng.candidate_cache.stats()
        assert stats["version"] == 1 and stats["invalidations"] == 1
        ref_eng = fresh(new_head)
        ref = ref_eng.submit(Request(prompt=prompt, max_new_tokens=4))
        ref_eng.run()
        assert h.tokens == ref.tokens

    def test_cache_disabled_engine_matches(self):
        rng = np.random.default_rng(13)
        prompt = rng.integers(0, CFG.vocab_size, 4).astype(np.int32)
        outs = []
        for use_cache in (True, False):
            eng = Engine(CFG, HCFG, PARAMS, HEAD_STATE, ServeConfig(
                n_slots=1, max_len=MAX_LEN, beam=BEAM, page_len=3,
                use_candidate_cache=use_cache, cache_dtype=torch.float32))
            h = eng.submit(Request(prompt=prompt, max_new_tokens=4))
            h2 = eng.submit(Request(prompt=prompt, max_new_tokens=4))
            eng.run()
            outs.append((h.tokens, h2.tokens))
            assert (eng.candidate_cache is not None) == use_cache
        assert outs[0] == outs[1]


class TestRetirement:
    def test_per_request_max_new_tokens(self):
        engine = shared_engine(page_len=3)
        rng = np.random.default_rng(17)
        lens = [1, 3, 2]
        handles = [engine.submit(Request(prompt=p, max_new_tokens=g))
                   for p, g in zip(prompts(rng, 3), lens)]
        engine.run()
        assert [len(h.tokens) for h in handles] == lens

    def test_eos_stops_early_and_frees_lane_and_pages(self):
        engine = shared_engine(page_len=3)
        rng = np.random.default_rng(19)
        prompt = rng.integers(0, CFG.vocab_size, 3).astype(np.int32)
        h_ref = engine.submit(Request(prompt=prompt, max_new_tokens=5))
        engine.run()
        assert len(h_ref.tokens) == 5
        eos = h_ref.tokens[2]
        first = h_ref.tokens.index(eos)
        h = engine.submit(Request(prompt=prompt, max_new_tokens=5, eos_id=eos))
        engine.run()
        assert h.eos_hit and len(h.tokens) == first + 1
        assert h.tokens == h_ref.tokens[:first + 1]
        assert engine.pool.num_free_lanes == N_SLOTS
        assert engine.pool.num_mapped_pages == 0

    def test_oversized_request_rejected(self):
        engine = shared_engine(page_len=3)
        with pytest.raises(ValueError):
            engine.submit(Request(prompt=np.zeros((MAX_LEN,), np.int32), max_new_tokens=1))

    def test_zero_budget_request_rejected(self):
        engine = shared_engine(page_len=3)
        with pytest.raises(ValueError):
            engine.submit(Request(prompt=np.zeros((2,), np.int32), max_new_tokens=0))

    def test_streaming_matches_result(self):
        engine = shared_engine(page_len=3)
        rng = np.random.default_rng(23)
        prompt = rng.integers(0, CFG.vocab_size, 3).astype(np.int32)
        h = engine.submit(Request(prompt=prompt, max_new_tokens=4))
        assert list(engine.stream(h)) == list(h.result())


def test_unported_configurations_raise():
    """Mesh serving is ported (tests/test_torch_parallel_serve.py): a
    ``mesh`` that is not a ``DeviceMesh`` raises. SSM serving is ported: an
    SSM engine builds, with one nominal page per lane, and refuses prefix
    sharing (its state is recurrent, not position-local)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        Engine(CFG, HCFG, PARAMS, HEAD_STATE, ServeConfig(mesh=object()))
    ssm = dataclasses.replace(CFG, block="ssm", ssm_state=16, ssm_head_dim=16)
    params = transformer.init_params(torch.Generator().manual_seed(0), ssm, device="cpu")
    eng = Engine(ssm, HCFG, params, HEAD_STATE, ServeConfig(n_slots=2, max_len=8, page_len=2))
    assert (eng.pool.page_len, eng.pool.n_pages) == (8, 2)
    with pytest.raises(AssertionError, match="recurrent state"):
        Engine(ssm, HCFG, params, HEAD_STATE, ServeConfig(prefix_sharing=True))
