"""The port's engine with its multi-tenant features — prefix sharing with
copy-on-write tails and trie eviction, speculative decode, SLA scheduling
(priority classes, preemption with spill and restore, on-demand page
growth) — mirrored case for case from ``tests/test_serve_engine.py``.
Torch against torch: each request's token ids equal the port's lock-step
decode (``repro_torch.serve.lockstep_decode``)."""
import numpy as np
import pytest
from _torch_serve_common import (BEAM, CFG, lockstep, mt_engine, one_thread,  # noqa: F401
                                 prompts)

from repro_torch.serve import Request, TrafficConfig, drive, make_heavy_tail_mix


class TestPrefixSharing:
    def test_shared_template_byte_identity_and_hits(self):
        rng = np.random.default_rng(101)
        template = rng.integers(0, CFG.vocab_size, 6).astype(np.int32)
        ps = [template.copy(),
              np.concatenate([template, rng.integers(0, CFG.vocab_size, 2)]),
              np.concatenate([template, rng.integers(0, CFG.vocab_size, 3)]),
              template.copy()]
        ps = [np.asarray(p, np.int32) for p in ps]
        gen = 3
        refs = [lockstep(p[None], gen, BEAM)[0] for p in ps]
        eng = mt_engine(prefix_sharing=True)
        handles = [eng.submit(Request(prompt=p, max_new_tokens=gen)) for p in ps]
        eng.run()
        for h, ref in zip(handles, refs):
            np.testing.assert_array_equal(h.result(), ref)
        st = eng.stats()
        assert st["prefix"]["hits"] >= 1
        assert st["prefix"]["pages_reused"] >= 1
        assert st["prefix"]["prefill_tokens_saved"] > 0
        assert st["pages_in_use"] == 0 and st["pages_cached"] > 0
        eng.pool.check_invariants()

    def test_exact_repeat_takes_cow_tail(self):
        rng = np.random.default_rng(103)
        prompt = rng.integers(0, CFG.vocab_size, 5).astype(np.int32)
        gen = 3
        ref = lockstep(prompt[None], gen, BEAM)[0]
        eng = mt_engine(prefix_sharing=True)
        h1 = eng.submit(Request(prompt=prompt, max_new_tokens=gen))
        eng.run()
        h2 = eng.submit(Request(prompt=prompt.copy(), max_new_tokens=gen))
        eng.run()
        np.testing.assert_array_equal(h1.result(), ref)
        np.testing.assert_array_equal(h2.result(), ref)
        st = eng.stats()["prefix"]
        assert st["cow_copies"] >= 1 and st["hits"] >= 1
        assert st["prefill_tokens_saved"] >= prompt.size
        eng.pool.check_invariants()

    def test_trie_eviction_under_page_pressure(self):
        rng = np.random.default_rng(107)
        gen = 3
        eng = mt_engine(prefix_sharing=True, n_slots=1, n_pages=4)
        for _ in range(3):
            p = rng.integers(0, CFG.vocab_size, 4).astype(np.int32)
            ref = lockstep(p[None], gen, BEAM)[0]
            h = eng.submit(Request(prompt=p, max_new_tokens=gen))
            eng.run()
            np.testing.assert_array_equal(h.result(), ref)
        assert eng.stats()["prefix"]["evictions"] >= 1
        eng.pool.check_invariants()


class TestSpeculativeDecode:
    def _run_twice(self, eng, ps, refs, gen):
        """Cold pass, then warm pass with replay drafts live."""
        for _ in range(2):
            handles = [eng.submit(Request(prompt=p, max_new_tokens=gen)) for p in ps]
            eng.run()
            for h, ref in zip(handles, refs):
                np.testing.assert_array_equal(h.result(), ref)

    @pytest.mark.parametrize("max_draft,page_len", [(1, 3), (4, 3)])
    def test_byte_identity_drafts_x_geometry(self, max_draft, page_len, n_pages=8):
        rng = np.random.default_rng(113 + max_draft)
        gen = 4
        ps = prompts(rng, 3, lo=2, hi=5)
        refs = [lockstep(p[None], gen, BEAM)[0] for p in ps]
        eng = mt_engine(spec_decode=True, max_draft=max_draft, page_len=page_len,
                        n_pages=n_pages)
        self._run_twice(eng, ps, refs, gen)
        st = eng.stats()["spec"]
        assert st["verify_steps"] > 0
        assert st["drafts_accepted"] > 0
        assert st["mean_emitted_per_step"] > 1.0
        eng.pool.check_invariants()

    @pytest.mark.parametrize("max_draft,page_len", [(3, 1), (2, 7)])
    def test_byte_identity_odd_geometries(self, max_draft, page_len):
        self.test_byte_identity_drafts_x_geometry(max_draft, page_len, n_pages=0)

    def test_dense_head_spec_identity(self):
        rng = np.random.default_rng(127)
        gen = 4
        ps = prompts(rng, 2, lo=3, hi=4)
        refs = [lockstep(p[None], gen, 0)[0] for p in ps]
        eng = mt_engine(spec_decode=True, max_draft=3, beam=0)
        self._run_twice(eng, ps, refs, gen)

    def test_sharing_and_spec_together(self):
        rng = np.random.default_rng(129)
        prompt = rng.integers(0, CFG.vocab_size, 6).astype(np.int32)
        gen = 4
        ref = lockstep(prompt[None], gen, BEAM)[0]
        eng = mt_engine(prefix_sharing=True, spec_decode=True, max_draft=3)
        for _ in range(2):
            h = eng.submit(Request(prompt=prompt.copy(), max_new_tokens=gen))
            eng.run()
            np.testing.assert_array_equal(h.result(), ref)
        st = eng.stats()
        assert st["prefix"]["hits"] >= 1
        assert st["spec"]["drafts_accepted"] > 0
        eng.pool.check_invariants()


class TestSlaScheduling:
    def test_priority_class_admitted_before_fifo_order(self):
        rng = np.random.default_rng(131)
        pa = rng.integers(0, CFG.vocab_size, 3).astype(np.int32)
        pb = rng.integers(0, CFG.vocab_size, 3).astype(np.int32)
        refs = [lockstep(p[None], 2, BEAM)[0] for p in (pa, pb)]
        eng = mt_engine(n_slots=1)
        lo = eng.submit(Request(prompt=pa, max_new_tokens=2, priority=0))
        hi = eng.submit(Request(prompt=pb, max_new_tokens=2, priority=5))
        eng.run()
        assert list(eng.admission_order) == [hi.request_id, lo.request_id]
        np.testing.assert_array_equal(lo.result(), refs[0])
        np.testing.assert_array_equal(hi.result(), refs[1])

    def test_preemption_spill_restore_byte_identity(self):
        rng = np.random.default_rng(137)
        whale_p = rng.integers(0, CFG.vocab_size, 5).astype(np.int32)
        quick_p = rng.integers(0, CFG.vocab_size, 4).astype(np.int32)
        ref_w = lockstep(whale_p[None], 7, BEAM)[0]
        ref_q = lockstep(quick_p[None], 3, BEAM)[0]
        eng = mt_engine(n_pages=6, preemption=True)
        hw = eng.submit(Request(prompt=whale_p, max_new_tokens=7, priority=0))
        eng.step()
        hq = eng.submit(Request(prompt=quick_p, max_new_tokens=3, priority=1))
        eng.run()
        np.testing.assert_array_equal(hw.result(), ref_w)
        np.testing.assert_array_equal(hq.result(), ref_q)
        st = eng.stats()["sched"]
        assert st["preemptions"] >= 1 and st["restores"] >= 1
        assert hw.preempted >= 1 and hq.preempted == 0
        eng.pool.check_invariants()
        assert eng.pool.num_in_use == 0

    def test_ondemand_growth_packs_more_lanes(self):
        rng = np.random.default_rng(139)
        ps = [rng.integers(0, CFG.vocab_size, 4).astype(np.int32) for _ in range(2)]
        gen = 3
        refs = [lockstep(p[None], gen, BEAM)[0] for p in ps]
        active_after_admit = {}
        for growth in ("reserve", "ondemand"):
            eng = mt_engine(n_pages=4, page_growth=growth)
            handles = [eng.submit(Request(prompt=p, max_new_tokens=gen)) for p in ps]
            eng.step()
            active_after_admit[growth] = eng.num_active
            eng.run()
            for h, ref in zip(handles, refs):
                np.testing.assert_array_equal(h.result(), ref)
            if growth == "ondemand":
                assert eng.stats()["sched"]["page_grows"] >= 1
            eng.pool.check_invariants()
        assert active_after_admit["reserve"] == 1
        assert active_after_admit["ondemand"] == 2

    def test_reserved_unwritten_pages_reported(self):
        eng = mt_engine(n_slots=1)
        rng = np.random.default_rng(141)
        prompt = rng.integers(0, CFG.vocab_size, 2).astype(np.int32)
        eng.submit(Request(prompt=prompt, max_new_tokens=7))
        eng.step()
        st = eng.stats()
        assert st["pages_in_use"] == 3
        assert st["pages_reserved_unwritten"] == 2
        eng.run()
        assert eng.stats()["pages_reserved_unwritten"] == 0

    def test_deadline_miss_counted(self):
        eng = mt_engine(n_slots=1)
        rng = np.random.default_rng(143)
        prompt = rng.integers(0, CFG.vocab_size, 3).astype(np.int32)
        h = eng.submit(Request(prompt=prompt, max_new_tokens=2, deadline_s=1e-9))
        eng.run()
        assert h.done
        assert eng.stats()["sched"]["deadline_misses"] >= 1


def test_drive_reports_per_class_latency():
    tcfg = TrafficConfig(
        n_requests=8, rate=500.0, prompt_len=3, gen_tokens=2, prompt_len_choices=(2, 3),
        gen_tokens_choices=(1, 2), vocab_size=CFG.vocab_size, interactive_frac=0.5,
        interactive_priority=1, seed=17)
    wl = make_heavy_tail_mix(tcfg)
    eng = mt_engine()
    res = drive(eng, wl, time_scale=0.0)
    assert res["n_requests"] == 8
    classes = res["per_class"]
    assert set(classes) == {r.priority for _, r in wl}
    for snap in classes.values():
        assert snap["n"] >= 1
        assert snap["latency_p99_ms"] >= snap["latency_p50_ms"] >= 0
    assert sum(s["n"] for s in classes.values()) == 8


@pytest.mark.parametrize("seed", [0, 1])
def test_all_features_on_mixed_traffic(seed):
    """Sharing, speculation, preemption and on-demand growth together, on a
    heavy-tail mix of two priority classes through an undersized pool: every
    request's tokens equal the lock-step decode, and the pool drains."""
    tcfg = TrafficConfig(
        n_requests=10, rate=500.0, prompt_len=3, gen_tokens=2,
        prompt_len_choices=(2, 4, 6), gen_tokens_choices=(2, 4), vocab_size=CFG.vocab_size,
        interactive_frac=0.4, interactive_priority=1, seed=seed)
    wl = make_heavy_tail_mix(tcfg)
    eng = mt_engine(n_pages=6, prefix_sharing=True, spec_decode=True, max_draft=3,
                    preemption=True, page_growth="ondemand")
    for _ in range(2):
        handles = [eng.submit(r) for _, r in wl]
        eng.run()
        for h in handles:
            ref = lockstep(h.request.prompt[None], h.request.max_new_tokens, BEAM)[0]
            np.testing.assert_array_equal(h.result(), ref)
        eng.pool.check_invariants()
        assert eng.pool.num_in_use == 0
