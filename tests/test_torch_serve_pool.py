"""The port's serving bookkeeping (``repro_torch.serve``: ``PagedPool``,
``PrefixIndex``, ``CandidateCache``, ``ContinuationStore`` and the traffic
generators) against the JAX package's ``repro.serve`` on the same operation
sequences and seeds, and the allocator's own properties mirrored from
``tests/test_serve_engine.py`` (hypothesis suites, units, COW and
spill/restore byte identity on the port's in-place arena).

The host bookkeeping is a line-for-line port, so the page ids, refcounts,
page tables, matches, evictions and workloads are compared for equality;
the arenas' bytes after COW and spill/restore equal the reference's
exactly (both copy bytes, neither computes).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st
from _torch_serve_common import CFG, MAX_LEN, one_thread  # noqa: F401

from repro.models.config import ModelConfig as JModelConfig
from repro.serve import CandidateCache as JCandidateCache
from repro.serve import ContinuationStore as JContinuationStore
from repro.serve import PagedPool as JPagedPool
from repro.serve import PrefixIndex as JPrefixIndex
from repro.serve import traffic as jtraffic
from repro_torch.serve import (CandidateCache, ContinuationStore, PagedPool,
                               PrefixIndex, TrafficConfig, make_heavy_tail_mix,
                               make_shared_prefix_burst, make_workload)
from repro_torch.serve.spec import CTX_WINDOW

JCFG = JModelConfig(**dataclasses.asdict(CFG))


def _fresh_pool(n_lanes=3, n_pages=8, page_len=3, max_len=9):
    return PagedPool(CFG, n_lanes, n_pages, page_len, max_len, dtype=torch.float32,
                     device="cpu")


def _drive_allocator(pool, seed, n_ops):
    """Random alloc/release interleaving; returns the live lane->pages map
    mirror kept independently of the pool's own bookkeeping."""
    rng = np.random.default_rng(seed)
    live = {}
    for _ in range(n_ops):
        if live and (rng.random() < 0.5 or not pool.num_free_lanes):
            lane = list(live)[rng.integers(0, len(live))]
            got = pool.release(lane)
            assert sorted(got) == sorted(live.pop(lane))
        else:
            need = int(rng.integers(1, pool.max_pages + 1))
            expect = pool.can_admit(need)
            out = pool.alloc(need)
            assert (out is not None) == expect
            if out is not None:
                lane, pages = out
                assert len(pages) == need
                live[lane] = pages
        pool.check_invariants()
    return live


class TestPageAllocator:
    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**20), n_ops=st.integers(1, 40))
    def test_free_and_mapped_partition_pages(self, seed, n_ops):
        pool = _fresh_pool()
        live = _drive_allocator(pool, seed, n_ops)
        mapped = {p for pages in live.values() for p in pages}
        assert len(mapped) == sum(len(v) for v in live.values())
        assert pool.num_mapped_pages == len(mapped)
        assert pool.num_free_pages == pool.n_pages - len(mapped)

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**20), n_ops=st.integers(1, 40))
    def test_drained_pool_is_indistinguishable_from_fresh(self, seed, n_ops):
        pool = _fresh_pool()
        live = _drive_allocator(pool, seed, n_ops)
        for lane in list(live):
            pool.release(lane)
        fresh = _fresh_pool()
        assert set(pool._free_pages) == set(fresh._free_pages)
        assert set(pool._free_lanes) == set(fresh._free_lanes)
        assert pool._pages_of == {}
        np.testing.assert_array_equal(pool.page_table, fresh.page_table)

    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**20), n_lanes=st.integers(1, 4),
           page_len=st.sampled_from([1, 2, 3, 5, 9]))
    def test_alloc_never_exceeds_capacity(self, seed, n_lanes, page_len):
        max_len = 9
        n_pages = max(-(-max_len // page_len), 5)
        pool = PagedPool(CFG, n_lanes, n_pages, page_len, max_len, dtype=torch.float32,
                         device="cpu")
        rng = np.random.default_rng(seed)
        granted = 0
        while True:
            need = int(rng.integers(1, pool.max_pages + 1))
            out = pool.alloc(need)
            if out is None:
                assert pool.num_free_lanes == 0 or pool.num_free_pages < need
                break
            granted += len(out[1])
            pool.check_invariants()
        assert granted == pool.num_mapped_pages <= n_pages

    @settings(max_examples=25, deadline=None)
    @given(total_len=st.integers(1, 9), page_len=st.sampled_from([1, 2, 3, 4, 9]))
    def test_pages_needed_covers_exactly(self, total_len, page_len):
        pool = PagedPool(CFG, 2, 12, page_len, 9, dtype=torch.float32, device="cpu")
        need = pool.pages_needed(total_len)
        assert need * page_len >= total_len
        assert (need - 1) * page_len < total_len

    def test_double_release_and_bad_lane_rejected(self):
        pool = _fresh_pool()
        lane, pages = pool.alloc(2)
        assert pool.release(lane) == pages
        with pytest.raises(AssertionError):
            pool.release(lane)
        with pytest.raises(AssertionError):
            pool.release(pool.n_lanes - 1)

    def test_sink_page_outside_allocator_range(self):
        pool = _fresh_pool(n_pages=4)
        assert pool.sink == 4
        assert pool.cache["k"].shape[1] == 5
        seen = set()
        while pool.can_admit(1):
            seen.update(pool.alloc(1)[1])
        assert pool.sink not in seen
        assert (pool.page_table <= pool.sink).all()


class TestPagedPoolUnit:
    def test_arena_shape(self):
        pool = PagedPool(CFG, 4, 6, 4, 16, dtype=torch.float32, device="cpu")
        assert pool.cache["k"].shape == (
            CFG.num_layers, 7, 4, CFG.num_kv_heads, CFG.resolved_head_dim)
        assert pool.max_pages == 4
        assert pool.page_table.shape == (4, 4)

    def test_lifo_reuse(self):
        pool = _fresh_pool()
        lane, pages = pool.alloc(2)
        pool.release(lane)
        lane2, pages2 = pool.alloc(2)
        assert lane2 == lane
        assert pages2 == pages[::-1]

    def test_pool_too_small_for_max_len_rejected(self):
        with pytest.raises(AssertionError):
            PagedPool(CFG, 2, 2, 3, MAX_LEN, dtype=torch.float32, device="cpu")


class TestCandidateCacheUnit:
    def test_lru_eviction_and_stats(self):
        cc = CandidateCache(capacity=2)
        c = np.arange(4, dtype=np.int32)
        lp = np.zeros(4, np.float32)
        cc.put((1,), c, lp)
        cc.put((2,), c, lp)
        assert cc.get((1,)) is not None
        cc.put((3,), c, lp)
        assert cc.get((2,)) is None
        assert cc.get((3,)) is not None
        assert cc.evictions == 1
        assert cc.stats()["hits"] == 2 and cc.stats()["misses"] == 1

    def test_hit_returns_stored_arrays(self):
        cc = CandidateCache(capacity=4)
        c = np.array([5, 7, -1], np.int32)
        lp = np.array([-0.5, -1.5, -np.inf], np.float32)
        cc.put((0, 1, 2), c, lp)
        got_c, got_lp = cc.get((0, 1, 2))
        np.testing.assert_array_equal(got_c, c)
        np.testing.assert_array_equal(got_lp, lp)


# --- refcounted / shared pages ------------------------------------------------

def _fill_arena(pool, seed):
    """Overwrite the K/V arena in place with recognizable random bytes."""
    rng = np.random.default_rng(seed)
    for key in ("k", "v"):
        pool.cache[key].copy_(torch.from_numpy(
            rng.normal(size=tuple(pool.cache[key].shape)).astype(np.float32)))


def _drive_shared_allocator(pool, seed, n_ops):
    """Random interleaving of alloc / alloc_shared / cow / release /
    register / unregister / cached-revival, mirroring refcounts."""
    rng = np.random.default_rng(seed)
    live = {}
    for _ in range(n_ops):
        r = rng.random()
        if live and r < 0.25:
            lane = sorted(live)[rng.integers(0, len(live))]
            got = pool.release(lane)
            assert sorted(got) == sorted(live.pop(lane))
        elif live and r < 0.40:
            donor = sorted(live)[rng.integers(0, len(live))]
            pages = pool.lane_pages(donor)
            k = int(rng.integers(1, len(pages) + 1))
            npriv = int(rng.integers(0, pool.max_pages - k + 1))
            out = pool.alloc_shared(pages[:k], npriv)
            if out is not None:
                lane, priv = out
                live[lane] = pages[:k] + priv
        elif live and r < 0.50:
            cands = [(lane, i) for lane, pages in live.items()
                     for i, p in enumerate(pages) if pool.refcount(p) > 1]
            if cands and pool.num_free_pages:
                lane, i = cands[rng.integers(0, len(cands))]
                live[lane][i] = pool.cow(lane, i)
        elif live and r < 0.60:
            lane = sorted(live)[rng.integers(0, len(live))]
            pages = live[lane]
            pool.register(pages[:int(rng.integers(1, len(pages) + 1))])
        elif r < 0.68:
            regs = sorted(pool._registered)
            if regs:
                pool.unregister([regs[rng.integers(0, len(regs))]])
        elif pool._cached and r < 0.76:
            cached = sorted(pool._cached)
            k = int(rng.integers(1, min(len(cached), pool.max_pages) + 1))
            out = pool.alloc_shared(cached[:k], 0)
            if out is not None:
                lane, _ = out
                live[lane] = cached[:k]
        else:
            need = int(rng.integers(1, pool.max_pages + 1))
            expect = pool.can_admit(need)
            out = pool.alloc(need)
            assert (out is not None) == expect
            if out is not None:
                lane, pages = out
                live[lane] = pages
        pool.check_invariants()
        counts = {}
        for pages in live.values():
            for p in pages:
                counts[p] = counts.get(p, 0) + 1
        for p in range(pool.n_pages):
            assert pool.refcount(p) == counts.get(p, 0)
            in_free = p in pool._free_pages
            assert (pool.refcount(p) == 0) == (in_free or pool.is_cached(p))
            assert not (in_free and pool.is_cached(p))
    return live


class TestRefcountedPool:
    @settings(max_examples=20, deadline=None)
    @given(seed=st.integers(0, 2**20), n_ops=st.integers(1, 50))
    def test_sharing_preserves_partition_and_refcounts(self, seed, n_ops):
        pool = _fresh_pool(n_lanes=4, n_pages=8, page_len=3, max_len=9)
        _drive_shared_allocator(pool, seed, n_ops)

    @settings(max_examples=20, deadline=None)
    @given(seed=st.integers(0, 2**20), n_ops=st.integers(1, 50))
    def test_drained_unregistered_pool_matches_fresh(self, seed, n_ops):
        pool = _fresh_pool(n_lanes=4, n_pages=8, page_len=3, max_len=9)
        live = _drive_shared_allocator(pool, seed, n_ops)
        for lane in list(live):
            pool.release(lane)
        pool.unregister(sorted(pool._registered))
        fresh = _fresh_pool(n_lanes=4, n_pages=8, page_len=3, max_len=9)
        assert set(pool._free_pages) == set(fresh._free_pages)
        assert len(pool._free_pages) == pool.n_pages
        assert set(pool._free_lanes) == set(fresh._free_lanes)
        assert pool._pages_of == {} and pool._refcount == {}
        assert pool._cached == set()
        np.testing.assert_array_equal(pool.page_table, fresh.page_table)

    def test_cached_lifecycle_and_eviction_accounting(self):
        pool = _fresh_pool(n_lanes=2, n_pages=4, page_len=3, max_len=9)
        lane, pages = pool.alloc(3)
        pool.register(pages[:2])
        pool.release(lane)
        assert pool.num_cached_pages == 2 and pool.num_free_pages == 2
        assert not pool.can_admit(3) and pool.can_admit_evicting(3)
        lane2, _ = pool.alloc_shared(pages[:1], 1)
        assert pool.refcount(pages[0]) == 1
        assert not pool.is_cached(pages[0])
        pool.release(lane2)
        pool.unregister(pages[:2])
        assert pool.num_cached_pages == 0
        assert pool.num_free_pages == pool.n_pages
        pool.check_invariants()

    def test_retain_of_free_page_rejected(self):
        pool = _fresh_pool()
        with pytest.raises(AssertionError):
            pool.retain(pool._free_pages[-1])

    def test_cow_copies_bytes_and_preserves_donor(self):
        """COW gives the caller a private byte-identical page, in place in
        the arena; the donor keeps its mapping; refcounts split 2 -> 1 + 1."""
        pool = _fresh_pool()
        _fill_arena(pool, seed=3)
        arena_k = pool.cache["k"]
        lane_a, pages = pool.alloc(2)
        lane_b, priv = pool.alloc_shared(pages, 0)
        assert priv == [] and pool.refcount(pages[1]) == 2
        src = pages[1]
        before = {k: pool.cache[k][:, src].clone() for k in ("k", "v")}
        new = pool.cow(lane_b, 1)
        assert new != src and pool.cache["k"] is arena_k      # no reallocation
        assert pool.lane_pages(lane_a) == pages
        assert pool.lane_pages(lane_b) == [pages[0], new]
        assert pool.refcount(src) == 1 and pool.refcount(new) == 1
        for k in ("k", "v"):
            assert torch.equal(pool.cache[k][:, new], before[k])
        pool.check_invariants()

    def test_spill_restore_byte_identity(self):
        pool = _fresh_pool(n_lanes=2, n_pages=6, page_len=3, max_len=9)
        _fill_arena(pool, seed=5)
        lane, pages = pool.alloc(3)
        expect = {k: pool.cache[k][:, pages].clone() for k in ("k", "v")}
        img = pool.spill(lane)
        assert img.n_pages == 3 and img.nbytes() > 0
        for k in ("k", "v"):
            assert img.pages[k].device.type == "cpu" and torch.equal(img.pages[k], expect[k])
        pool.release(lane)
        for leaf in pool.cache.values():
            leaf.zero_()
        lane2, pages2 = pool.restore(img)
        for k in ("k", "v"):
            assert torch.equal(pool.cache[k][:, pages2], expect[k])
        pool.check_invariants()


class TestContinuationStore:
    def test_chain_lru_and_version(self):
        cs = ContinuationStore(capacity=3)
        cs.put((1, 2), 3)
        cs.put((1, 2, 3), 4)
        cs.put((1, 2, 3, 4), 5)
        assert cs.chain((1, 2), 5) == [3, 4, 5]
        cs.put((9,), 9)
        assert cs.get((1, 2)) is None
        assert len(cs._map) == 3

    def test_bump_version_orphans_stale_entries(self):
        cs = ContinuationStore(capacity=8)
        cs.put((1, 2), 3)
        assert cs.get((1, 2)) == 3
        cs.bump_version()
        assert cs.get((1, 2)) is None
        cs.put((1, 2), 7)
        assert cs.chain((1, 2), 2) == [7]

    def test_ctx_window_bounds_key_length(self):
        cs = ContinuationStore(capacity=4)
        long_ctx = tuple(range(CTX_WINDOW + 50))
        cs.put(long_ctx, 1)
        assert cs.get((99,) * 7 + long_ctx[-CTX_WINDOW:]) == 1


# --- against the JAX package ----------------------------------------------------

def _pool_state(pool):
    return (list(pool._free_pages), list(pool._free_lanes),
            {k: list(v) for k, v in pool._pages_of.items()}, dict(pool._refcount),
            sorted(pool._registered), sorted(pool._cached), pool.page_table.tolist())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_and_prefix_index_match_reference(seed):
    """The same random sequence of admissions with prefix matching, COW
    tails, trie insertion, LRU eviction, growth, spill/restore and release,
    on the port's pool and index and on the reference's: equal page ids,
    refcounts, page tables, matches and evictions at every step, and equal
    arena bytes at the end."""
    rng = np.random.default_rng(seed)
    page_len, n_pages, n_lanes, max_len = 3, 10, 3, 12
    tpool = PagedPool(CFG, n_lanes, n_pages, page_len, max_len, dtype=torch.float32,
                      device="cpu")
    jpool = JPagedPool(JCFG, n_lanes, n_pages, page_len, max_len, dtype=jnp.float32)
    fill = np.random.default_rng(seed + 100).normal(
        size=tuple(tpool.cache["k"].shape)).astype(np.float32)
    for key in ("k", "v"):
        tpool.cache[key].copy_(torch.from_numpy(fill))
    jpool.cache = {key: jnp.asarray(fill) for key in ("k", "v")}
    tidx, jidx = PrefixIndex(page_len), JPrefixIndex(page_len)
    templates = [rng.integers(0, 20, 7) for _ in range(3)]
    live, images = [], []
    for _ in range(40):
        r = rng.random()
        if r < 0.45:
            t = templates[rng.integers(0, 3)]
            prompt = np.concatenate([t, rng.integers(0, 20, rng.integers(0, 3))])
            prompt = prompt[:rng.integers(3, prompt.size + 1)].astype(np.int32)
            tm, jm = tidx.match(prompt), jidx.match(prompt)
            assert (tm.pages, tm.tokens_matched, tm.tail_page, tm.tail_len) == (
                jm.pages, jm.tokens_matched, jm.tail_page, jm.tail_len)
            need = -(-(prompt.size + 1) // page_len)
            shared = list(tm.pages) + ([tm.tail_page] if tm.tail_page is not None else [])
            while (tpool.num_free_pages < need - len(tm.pages) and tidx.evict_lru(tpool)):
                assert jidx.evict_lru(jpool)
                tm, jm = tidx.match(prompt), jidx.match(prompt)
                shared = list(tm.pages) + ([tm.tail_page] if tm.tail_page is not None else [])
            if tpool.num_free_lanes and tpool.num_free_pages >= need - len(tm.pages):
                got_t = tpool.alloc_shared(shared, need - len(shared))
                got_j = jpool.alloc_shared(shared, need - len(shared))
                assert got_t == got_j
                if tm.tail_page is not None:
                    assert tpool.cow(got_t[0], len(tm.pages)) == jpool.cow(got_j[0],
                                                                           len(tm.pages))
                live.append((got_t[0], prompt))
                tidx.insert(prompt, tpool.lane_pages(got_t[0]), tpool)
                jidx.insert(prompt, jpool.lane_pages(got_j[0]), jpool)
        elif r < 0.6 and live:
            lane, _ = live[rng.integers(0, len(live))]
            if len(tpool.lane_pages(lane)) < tpool.max_pages:
                assert tpool.grow(lane, 1) == jpool.grow(lane, 1)
        elif r < 0.7 and live:
            lane, prompt = live.pop(rng.integers(0, len(live)))
            images.append((tpool.spill(lane), jpool.spill(lane)))
            assert tpool.release(lane) == jpool.release(lane)
        elif r < 0.8 and images:
            timg, jimg = images[-1]
            got = tpool.restore(timg)
            assert got == jpool.restore(jimg)
            if got is not None:
                images.pop()
                live.append((got[0], None))
        elif live:
            lane, _ = live.pop(rng.integers(0, len(live)))
            assert tpool.release(lane) == jpool.release(lane)
        tpool.check_invariants()
        assert _pool_state(tpool) == _pool_state(jpool)
        assert (tidx.n_nodes, tidx.n_tails) == (jidx.n_nodes, jidx.n_tails)
    for key in ("k", "v"):
        np.testing.assert_array_equal(tpool.cache[key].numpy(), np.asarray(jpool.cache[key]))


def test_candidate_cache_and_continuation_store_match_reference():
    rng = np.random.default_rng(7)
    t_cc, j_cc = CandidateCache(capacity=5), JCandidateCache(capacity=5)
    t_cs, j_cs = ContinuationStore(capacity=6), JContinuationStore(capacity=6)
    keys = [tuple(rng.integers(0, 4, rng.integers(1, 4)).tolist()) for _ in range(12)]
    for step in range(80):
        key = keys[rng.integers(0, len(keys))]
        op = rng.random()
        if op < 0.4:
            c = rng.integers(0, 50, 4).astype(np.int32)
            lp = rng.normal(size=4).astype(np.float32)
            t_cc.put(key, c, lp)
            j_cc.put(key, c, lp)
            t_cs.put(key, int(c[0]))
            j_cs.put(key, int(c[0]))
        elif op < 0.9:
            got, want = t_cc.get(key), j_cc.get(key)
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got[0], want[0])
            assert t_cs.chain(key, 3) == j_cs.chain(key, 3)
        else:
            t_cc.bump_version()
            j_cc.bump_version()
            t_cs.bump_version()
            j_cs.bump_version()
        assert t_cc.stats() == j_cc.stats()
        assert (t_cs.hits, t_cs.misses, list(t_cs._map)) == (
            j_cs.hits, j_cs.misses, list(j_cs._map))


def _same_workload(got, want):
    assert len(got) == len(want)
    for (tg, rg), (tw, rw) in zip(got, want):
        assert tg == tw
        np.testing.assert_array_equal(rg.prompt, rw.prompt)
        assert (rg.max_new_tokens, rg.eos_id, rg.priority, rg.deadline_s) == (
            rw.max_new_tokens, rw.eos_id, rw.priority, rw.deadline_s)


@pytest.mark.parametrize("kind", ["workload", "mixed", "burst", "heavy_tail"])
def test_traffic_generators_match_reference(kind):
    kw = dict(n_requests=48, rate=80.0, prompt_len=6, gen_tokens=3, vocab_size=90, seed=21)
    if kind == "mixed":
        kw.update(prompt_len_choices=(2, 5, 8), gen_tokens_choices=(1, 4), repeat_frac=0.3,
                  n_shared_prompts=2)
    elif kind == "burst":
        kw.update(n_templates=4, template_len=9, suffix_len=3, exact_repeat_frac=0.3,
                  burst=4, interactive_frac=0.5, interactive_priority=2)
    elif kind == "heavy_tail":
        kw.update(prompt_len_choices=(3, 5, 8), gen_tokens_choices=(2, 4),
                  interactive_frac=0.6, interactive_priority=1, interactive_deadline_s=0.5,
                  tail_alpha=1.2)
    fn = {"workload": "make_workload", "mixed": "make_workload",
          "burst": "make_shared_prefix_burst", "heavy_tail": "make_heavy_tail_mix"}[kind]
    got = {"make_workload": make_workload, "make_shared_prefix_burst":
           make_shared_prefix_burst, "make_heavy_tail_mix": make_heavy_tail_mix}[fn](
        TrafficConfig(**kw))
    want = getattr(jtraffic, fn)(jtraffic.TrafficConfig(**kw))
    _same_workload(got, want)


class TestTraffic:
    def test_workload_shapes_and_repeats(self):
        tcfg = TrafficConfig(n_requests=32, rate=100.0, prompt_len=5, gen_tokens=3,
                             vocab_size=50, repeat_frac=0.5, n_shared_prompts=1, seed=3)
        wl = make_workload(tcfg)
        assert len(wl) == 32
        arrivals = [t for t, _ in wl]
        assert arrivals == sorted(arrivals) and arrivals[0] == 0.0
        keys = {tuple(r.prompt.tolist()) for _, r in wl}
        assert len(keys) < 32
        for _, r in wl:
            assert r.prompt.shape == (5,) and r.max_new_tokens == 3

    def test_mixed_length_workload(self):
        tcfg = TrafficConfig(n_requests=64, rate=100.0, prompt_len=8, gen_tokens=4,
                             prompt_len_choices=(2, 5, 8), gen_tokens_choices=(1, 4),
                             vocab_size=50, seed=9)
        wl = make_workload(tcfg)
        assert {r.prompt.shape[0] for _, r in wl} == {2, 5, 8}
        assert {r.max_new_tokens for _, r in wl} == {1, 4}


class TestAdversarialTraffic:
    def test_shared_prefix_burst_shape(self):
        tcfg = TrafficConfig(
            n_requests=40, rate=100.0, gen_tokens=2, vocab_size=50, n_templates=4,
            template_len=6, suffix_len=2, exact_repeat_frac=0.3, burst=4,
            interactive_frac=0.5, interactive_priority=2, seed=11)
        wl = make_shared_prefix_burst(tcfg)
        assert len(wl) == 40
        arrivals = [t for t, _ in wl]
        assert arrivals == sorted(arrivals) and arrivals[0] == 0.0
        assert len(set(arrivals)) <= len(wl) // tcfg.burst + 1
        assert {r.prompt.shape[0] for _, r in wl} == {6, 8}
        keys = [tuple(r.prompt.tolist()) for _, r in wl]
        assert len(set(keys)) < len(keys)
        assert {r.priority for _, r in wl} == {0, 2}

    def test_heavy_tail_mix_shape(self):
        tcfg = TrafficConfig(
            n_requests=64, rate=100.0, prompt_len=3, gen_tokens=2,
            prompt_len_choices=(3, 5, 8), gen_tokens_choices=(2, 4), vocab_size=50,
            interactive_frac=0.6, interactive_priority=1, interactive_deadline_s=0.5,
            tail_alpha=1.2, seed=13)
        wl = make_heavy_tail_mix(tcfg)
        assert len(wl) == 64
        assert {r.priority for _, r in wl} == {0, 1}
        for _, r in wl:
            if r.priority == 1:
                assert r.prompt.shape[0] == 3 and r.max_new_tokens == 2
                assert r.deadline_s == 0.5
            else:
                assert r.prompt.shape[0] in (3, 5, 8)
                assert r.max_new_tokens in (2, 4)
                assert r.deadline_s is None
