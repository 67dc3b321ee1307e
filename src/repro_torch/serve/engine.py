"""Continuous-batching serving engine over the port's step functions: the
port of ``repro.serve.engine``. Every behaviour of the reference is kept;
where it jits and donates, the port launches eagerly and updates the
paged arena in place. Attention runs through the ``flash_attention``
kernel (paged on the decode and verify steps: the kernel reads K/V
through the page table); the beam path scores with ``gather_scores`` and
the dense path debiases with ``tree_logprob_all`` on the card, their plain
versions on the CPU.

One engine iteration (``Engine.step``) is: admit → decode → select → retire.

  admit   — pop queued requests into free decode lanes + freshly-allocated
            KV pages (``PagedPool.alloc``) and prefill ALL newly-admitted
            prompts in one padded call (``make_batched_prefill``,
            row- and length-bucketed to powers of two so the launch shapes
            stay few); new requests join mid-flight, no draining of the
            running batch. Admission order is per-priority-class
            (higher class first, FIFO within a class, a blocked class
            blocks everything below it); with ``prefix_sharing`` the
            longest full-chunk trie match maps already-resident prompt
            pages into the lane (refcounted, COW on a partial tail) and
            prefill skips the matched tokens; with
            ``page_growth="ondemand"`` admission reserves only the
            prompt + 1 pages and lanes grow (or spill/restore under
            pressure — ``preemption``) as generation proceeds.
  decode  — ONE ``make_paged_decode`` call for the whole pool:
            (B, 1) in-flight tokens, (B,) per-lane ``cache_pos``, and the
            (B, max_pages) page table mapping each lane's logical pages
            onto the shared arena. Free lanes ride along as masked garbage
            (their compute is the price of a static batch shape; their
            writes land in the sink page by construction).
  select  — next-token choice from the final hiddens. Dense path: full
            Eq. 5 debiased scores + argmax (O(C)). Beam path: the prefix-
            keyed ``CandidateCache`` is consulted per slot; on an all-hit
            step the O(beam·k·log C) tree descent is skipped entirely and
            the cached candidate sets go straight to re-scoring
            (O(beam·K) gather-and-dot, the gather_scores kernel on the
            card).
  retire  — per-lane EOS / max-new-tokens / max-len checks; finished
            requests release their lane AND their pages the same step
            (page reclamation), making room for the next admission.

With ``spec_decode`` the decode+select pair becomes a *verify* launch:
the replay-draft store proposes up to ``max_draft`` tokens per lane,
one batched ``paged_prefill`` scores the whole chain, and the longest
prefix matching the target's own Eq.-5 argmax is emitted — exact
accept/reject, so speculation changes latency, never output
(DESIGN.md §12).

Request lifecycle: QUEUED → RUNNING(lane, pages) → FINISHED. The caller
drives the loop (``step()`` / ``run()``) and reads results incrementally
through the streaming ``ResultStream`` handle returned by ``submit``.

Determinism: greedy decode has no RNG, admission order is a pure
function of the submitted sequence, and the per-slot math is
row-independent, so a request's output depends only on its prompt and
the params — byte-identical to the lock-step ``make_serve_step`` path
with sharing, speculation, and preemption in any combination
(tested in tests/test_torch_serve_engine.py). On the card the kernels'
split of a row's keys depends only on that row's key count and the
launch's shape, so a row gives the same bits paged and contiguous. The candidate cache can
only skip work, never change results: a prefix hit implies a bit-identical
hidden state, hence identical re-scored argmax.

Under a ``("data", "model")`` mesh (``ServeConfig.mesh``) every rank runs
the same engine on the same requests with its part of the model
(``parallel.sharding.shard_train_state``): the embedding's and the head's rows
are sharded over ``model`` (the token gather and the candidate scores are
collectives, the dense path merges each rank's argmax), the trunk's heads,
``d_ff``, experts and SSM heads too, and the paged arena is the rank's
part (KV heads over ``model`` where they divide): page counts are the
same on every rank, the ``stats`` bytes a rank's. The engine's clock is rank 0's, broadcast at every
reading, so deadline and admission decisions, which call different
collectives when they differ, are taken alike on every rank.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import heads as heads_lib
from repro_torch.core import tree as tree_lib
from repro_torch.core.heads import HeadConfig, HeadParams
from repro_torch.models import lm_head
from repro_torch.models.config import ModelConfig
from repro_torch.models import transformer
from repro_torch.obs import JsonlExporter, Registry
from repro_torch.obs.trace import span
from repro_torch.resilience import faults
from repro_torch.serve.cache_pool import PagedPool
from repro_torch.serve.candidate_cache import CandidateCache
from repro_torch.serve.prefix_index import PrefixIndex
from repro_torch.serve.spec import NullDraft, ReplayDraft
from repro_torch.parallel.sharding import check_mesh
from repro_torch.train.step import (dense_next_token, make_batched_prefill,
                                    make_paged_decode, make_paged_prefill,
                                    make_prefill, make_serve_step)


def lockstep_decode(cfg: ModelConfig, hcfg: HeadConfig, params, head_state,
                    prompts, gen_tokens: int, topk_beam: int = 0,
                    mesh=None, cache_dtype=torch.float32) -> np.ndarray:
    """Reference fixed-batch greedy decode — the pre-engine serving loop,
    on the port's ``make_prefill`` / ``make_serve_step``.

    THE byte-identity oracle for the engine: tests and examples compare
    ``Engine`` outputs against this exact loop, so it is defined once here.
    Runs on the parameters' device. Returns the (batch, gen_tokens)
    generated ids. Under ``mesh`` the params are a rank's
    (``parallel.shard_train_state``) and every rank decodes the same
    prompts.
    """
    if mesh is not None:
        check_mesh(mesh)
    dev = params["embed"].device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64).to(dev)
    b, pl = prompts.shape
    prefill = make_prefill(cfg, mesh=mesh)
    step = make_serve_step(cfg, hcfg, topk_beam=topk_beam, mesh=mesh)
    cache = transformer.init_cache(cfg, b, pl + gen_tokens,
                                   dtype=cache_dtype, device=dev, mesh=mesh)
    token, toks = prompts[:, -1:], []
    with torch.no_grad():
        _, cache = prefill(params, prompts, cache)
        for t in range(gen_tokens):
            token, cache = step(params, head_state, token, cache, pl + t)
            toks.append(token.cpu().numpy())
    return np.concatenate(toks, 1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs, the reference's fields and defaults with one
    exception: there is no ``use_kernel``: as in the lock-step path, the card
    always scores the beam's candidates with the ``gather_scores`` kernel
    (and debiases the dense path with ``tree_logprob_all``), and the CPU
    uses their plain versions. The engine runs on the parameters' device;
    ``cache_dtype`` is a torch dtype. ``mesh`` is a ``("data", "model")``
    ``DeviceMesh`` (the params then a rank's, module docstring) or None."""
    n_slots: int = 8             # concurrent decode lanes
    max_len: int = 256           # per-request KV capacity (prompt + new)
    page_len: int = 0            # KV page size; 0 = max_len (one page per
    #                              request: the monolithic-equivalent
    #                              geometry, full per-request reservation)
    n_pages: int = 0             # arena capacity; 0 = n_slots * pages-per-
    #                              max_len-request (byte-equivalent to the
    #                              old one-buffer-per-slot pool). Undersize
    #                              it (mixed-length traffic) to hold more
    #                              lanes in the same device bytes.
    batched_prefill: bool = True  # one padded prefill per admission round;
    #                               False = one call per request (same
    #                               bytes out — oracle-tested)
    beam: int = 0                # 0 = dense O(C) scoring; >0 = tree beam
    mesh: Any = None             # DeviceMesh: the params a rank's part
    use_candidate_cache: bool = True   # prefix-keyed descent skipping
    candidate_cache_capacity: int = 4096
    eos_id: Optional[int] = None       # engine-wide default stop token
    cache_dtype: Any = torch.float32
    retain_completed: int = 4096       # finished handles kept for audit;
    #                                    older ones drop (callers hold
    #                                    their own ResultStream refs)
    # -- multi-tenant knobs (DESIGN.md §12). All default OFF /
    #    legacy so the engine is drop-in identical unless opted in. --
    prefix_sharing: bool = False  # radix-trie shared prompt pages + COW
    spec_decode: bool = False     # tree-draft speculative decode
    max_draft: int = 4            # draft chain cap per verify step
    draft_capacity: int = 8192    # continuation-store LRU entries
    preemption: bool = False      # spill lower-priority lanes under
    #                               pressure (restore is byte-exact)
    page_growth: str = "reserve"  # "reserve" = worst-case pages at
    #                               admission; "ondemand" = admit on
    #                               prompt-size pages, grow at page
    #                               boundaries (evict/preempt/spill-self
    #                               when the free list runs dry)
    # -- resilience knobs (DESIGN.md §13). Both default OFF/legacy. --
    max_queue: int = 0            # bounded admission queue: submit()
    #                               beyond this depth returns a handle
    #                               with status="shed" instead of
    #                               enqueueing (0 = unbounded legacy)
    enforce_deadlines: bool = False  # abort requests past deadline_s —
    #                               queued ones are rejected, running
    #                               ones reclaim their lane + pages
    #                               mid-decode (legacy: advisory only)


@dataclasses.dataclass
class Request:
    """One generation request. ``eos_id=None`` inherits the engine default;
    ``max_new_tokens`` is the per-sequence length budget. ``priority`` is
    the SLA class (higher = more urgent; interactive traffic above batch):
    admission scans classes high→low, FIFO within a class, and with
    ``preemption`` a blocked higher class may spill strictly-lower lanes.
    ``deadline_s`` is an advisory per-request latency target recorded in
    the per-class stats (the scheduler does not drop late requests)."""
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    priority: int = 0
    deadline_s: Optional[float] = None


class ResultStream:
    """Streaming handle: ``tokens`` grows as the engine decodes; ``done``
    flips on retirement. Timestamps are perf_counter seconds.

    ``status`` reports how the request ended (DESIGN.md §13):
    ``"ok"`` — completed normally; ``"shed"`` — rejected at submit by the
    bounded admission queue; ``"deadline"`` — aborted past its
    ``deadline_s`` (under ``enforce_deadlines``); ``"error"`` — its
    prefill raised and the request was failed in isolation. Every
    non-"ok" terminal sets ``done`` with whatever tokens were produced.
    """

    def __init__(self, request: Request, request_id: int, now: float):
        self.request = request
        self.request_id = request_id
        self.tokens: List[int] = []
        self.done = False
        self.status = "ok"
        self.submitted_at = now
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        # -- scheduler state (engine-internal) --
        self.slot: Optional[int] = None
        self.cache_pos = 0
        self.next_input = 0
        self.history: List[int] = []
        self._eos: Optional[int] = None
        self.priority = request.priority
        self.admitted_seq = -1        # admission order, preemption tiebreak
        self.preempted = 0            # times spilled back to the queue
        self._spill = None            # PageSpill while waiting to restore
        self._suffix_start = 0        # prompt tokens covered by shared KV

    @property
    def eos_hit(self) -> bool:
        return bool(self.tokens) and self.tokens[-1] == self._eos

    def result(self) -> np.ndarray:
        assert self.done, "request still in flight"
        return np.asarray(self.tokens, np.int32)

    @property
    def latency(self) -> float:
        assert self.done
        return self.finished_at - self.submitted_at


class Engine:
    """Continuous-batching decode engine. See module docstring."""

    def __init__(self, cfg: ModelConfig, hcfg: HeadConfig, params,
                 head_state, serve_cfg: ServeConfig,
                 registry: Optional[Registry] = None,
                 exporter: Optional[JsonlExporter] = None,
                 metrics_interval: int = 1):
        self.mesh = serve_cfg.mesh
        if self.mesh is not None:
            check_mesh(self.mesh)
        self.cfg = cfg
        self.hcfg = hcfg
        self.params = params
        self.head_state = head_state
        self.scfg = serve_cfg
        self.device = params["embed"].device
        # Observability (repro.obs, DESIGN.md §10). The engine always
        # carries an enabled registry — its instruments back the
        # ``stats()`` latency view, and host-side bookkeeping is noise
        # next to a decode launch. Pass a shared registry to aggregate
        # across engines, or an ``exporter`` to stream ``request`` /
        # ``serve_step`` JSONL events (sampled every
        # ``metrics_interval`` engine iterations).
        self.registry = registry if registry is not None else Registry()
        self.exporter = exporter
        self.metrics_interval = max(metrics_interval, 1)
        reg = self.registry
        self._h_admission = reg.histogram("serve/admission_wait_s")
        self._h_ttft = reg.histogram("serve/ttft_s")
        self._h_latency = reg.histogram("serve/latency_s")
        self._c_tokens = reg.counter("serve/tokens")
        self._g_queue = reg.gauge("serve/queue_depth")
        self._g_active = reg.gauge("serve/active")
        self._g_pages = reg.gauge("serve/page_occupancy")
        page_len = serve_cfg.page_len or serve_cfg.max_len
        max_pages = -(-serve_cfg.max_len // page_len)
        n_pages = serve_cfg.n_pages or serve_cfg.n_slots * max_pages
        if cfg.block == "ssm":
            # Pure SSM: there is no K/V arena, so pages back no device
            # bytes and must never gate admission. One nominal page per
            # lane; lanes alone bound concurrency.
            page_len, n_pages = serve_cfg.max_len, serve_cfg.n_slots
        self.pool = PagedPool(cfg, serve_cfg.n_slots, n_pages, page_len,
                              serve_cfg.max_len,
                              dtype=serve_cfg.cache_dtype, device=self.device,
                              mesh=self.mesh)
        beam = serve_cfg.beam
        if beam:
            assert hcfg.kind == "adversarial_ns" and \
                head_state.gen.tree is not None, \
                "beam serving needs a fitted adversarial generator tree"
            beam = min(beam, tree_lib.padded_size(hcfg.num_labels))
        self.beam = beam
        self.candidate_cache = (
            CandidateCache(serve_cfg.candidate_cache_capacity)
            if beam and serve_cfg.use_candidate_cache else None)

        # -- multi-tenant machinery (DESIGN.md §12) --
        assert serve_cfg.page_growth in ("reserve", "ondemand"), \
            serve_cfg.page_growth
        if serve_cfg.prefix_sharing or serve_cfg.spec_decode:
            assert cfg.block == "attn", (
                "prefix sharing / speculative decode need position-local "
                "KV; SSM and hybrid caches carry recurrent state")
        self.prefix_index = (PrefixIndex(self.pool.page_len)
                             if serve_cfg.prefix_sharing else None)
        self.draft = (ReplayDraft(serve_cfg.draft_capacity)
                      if serve_cfg.spec_decode else NullDraft())
        # prefix-sharing counters
        self.share_lookups = 0
        self.share_hits = 0           # admissions reusing >= 1 page
        self.shared_pages_reused = 0  # pages NOT allocated thanks to trie
        self.prefill_tokens_saved = 0
        self.cow_copies = 0
        self.trie_evictions = 0
        # speculative-decode counters
        self.verify_steps = 0
        self.drafts_proposed = 0
        self.drafts_accepted = 0
        # scheduler counters
        self.preemptions = 0
        self.restores = 0
        self.page_grows = 0
        self.deadline_misses = 0
        self._class_hists: Dict[int, Any] = {}
        # resilience counters (DESIGN.md §13)
        self.shed_count = 0          # submits rejected by the queue bound
        self.deadline_aborts = 0     # requests aborted past deadline_s
        self.poisoned_count = 0      # requests failed in isolation
        self._compiled = False       # first launch done (readiness gate;
        #                              on the card it also builds the kernels)

        # Per-priority FIFO queues (higher class admits first; a blocked
        # class blocks everything below it — no sneaking past a starved
        # interactive request). Single-class traffic degenerates to the
        # old global FIFO exactly.
        self._queues: Dict[int, "deque[ResultStream]"] = {}
        self._active: Dict[int, ResultStream] = {}     # slot -> handle
        self._next_id = 0
        self._admit_seq = 0
        # Bounded audit trails — a long-running engine must not grow host
        # memory per request served; counters carry the lifetime totals.
        keep = serve_cfg.retain_completed
        self.admission_order: "deque[int]" = deque(maxlen=keep)
        self.completed: "deque[ResultStream]" = deque(maxlen=keep)
        self.completed_count = 0
        self.decode_steps = 0
        self.descent_skips = 0      # all-hit steps that skipped beam_search
        self.prefill_calls = 0      # padded batched-prefill launches
        self._occupancy_sum = 0
        self._page_occupancy_sum = 0
        self.peak_active = 0
        self.peak_pages_in_use = 0

        # Step functions. Each updates the pool's arena in place and
        # returns it; they run under ``step``'s ``torch.no_grad``.
        self._prefill = make_batched_prefill(
            cfg, self.pool.page_len, self.pool.sink,
            cache_dtype=serve_cfg.cache_dtype, mesh=self.mesh)
        self._decode = make_paged_decode(cfg, mesh=self.mesh)
        # Multi-token paged forward: shared-prefix suffix prefill AND the
        # speculative verify step share this one function.
        self._paged_prefill = (
            make_paged_prefill(cfg, mesh=self.mesh)
            if (serve_cfg.prefix_sharing or serve_cfg.spec_decode)
            else None)
        self._select_dense = self._build_dense_select()
        if beam:
            self._propose = self._build_propose()
            self._score = self._build_score()

    # -- head-path builders ---------------------------------------------

    def _build_dense_select(self):
        cfg, hcfg, mesh = self.cfg, self.hcfg, self.mesh

        def dense_select(params, head_state, h):
            return dense_next_token(cfg, hcfg, params, head_state, h, mesh).to(torch.int32)

        return dense_select

    def _build_propose(self):
        beam = self.beam

        def propose(head_state, h):
            x_gen = lm_head.gen_features(head_state, h)
            return tree_lib.beam_search(head_state.gen.tree, x_gen, beam,
                                        beam)

        return propose

    def _build_score(self):
        hcfg = self.hcfg
        score_fn = lm_head.serving_score_fn(self.cfg, mesh=self.mesh)

        def score(params, h, cand, log_pn):
            # heads.rescore_candidates is the same tail predictive_topk
            # runs, so engine outputs match the lock-step beam path
            # bit-for-bit.
            _, labels = heads_lib.rescore_candidates(
                hcfg, HeadParams(**params["head"]), h, cand, log_pn, 1,
                score_fn=score_fn)
            return labels[..., 0].to(torch.int32)

        return score

    def _now(self) -> float:
        """The engine's clock: ``time.perf_counter``, rank 0's under a mesh
        (broadcast at every reading, which every rank makes at the same
        point of the same control flow)."""
        now = time.perf_counter()
        if self.mesh is None:
            return now
        from repro_torch.parallel.collectives import broadcast_value
        return broadcast_value(now, self.device)

    # -- public API ------------------------------------------------------

    def submit(self, request: Request) -> ResultStream:
        prompt = np.asarray(request.prompt, np.int32)
        assert prompt.ndim == 1 and prompt.size >= 1, "prompt must be (S,)"
        if request.max_new_tokens < 1:
            # The engine always runs at least one decode step; a zero
            # budget would write at cache_pos == prompt_len + max_new,
            # one position past the request's page reservation.
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + request.max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds slot capacity "
                f"({self.scfg.max_len})")
        request = dataclasses.replace(request, prompt=prompt)
        handle = ResultStream(request, self._next_id, self._now())
        handle._eos = (request.eos_id if request.eos_id is not None
                       else self.scfg.eos_id)
        self._next_id += 1
        if (self.scfg.max_queue
                and self.num_pending >= self.scfg.max_queue):
            # Bounded admission: shed with an explicit status instead of
            # growing the queue without limit. The caller gets a DONE
            # handle it can retry against a less-loaded replica; latency
            # percentiles stay meaningful because the queue cannot hide
            # unbounded wait behind them.
            handle.status = "shed"
            handle.done = True
            handle.finished_at = handle.submitted_at
            self.shed_count += 1
            self.registry.counter("serve/shed").inc()
            return handle
        self._queues.setdefault(handle.priority, deque()).append(handle)
        self._g_queue.set(self.num_pending)
        return handle

    def swap_head_state(self, head_state) -> None:
        """Install a refreshed generator head state (online swap).

        The select/propose/score functions take ``head_state`` as an
        argument, so the swap rebuilds nothing. The candidate
        cache, however, holds (candidates, log_pn) pairs proposed by the
        OLD tree — under the new generator those candidate sets and Eq. 5
        debias terms are simply wrong, so every resident entry is
        invalidated (version bump): the next step on any prefix re-descends
        the new tree. Requests already in flight continue seamlessly
        against the new head (greedy decode keeps no head-side state
        between steps).
        """
        if self.beam:
            assert (self.hcfg.kind == "adversarial_ns"
                    and head_state.gen.tree is not None), \
                "beam serving needs a fitted adversarial generator tree"
        self.head_state = head_state
        if self.candidate_cache is not None:
            self.candidate_cache.bump_version()
        # Replayed continuations were decoded by the OLD tree — a new
        # draft from them would still be *verified* exactly (speculation
        # never affects outputs), but it would stop matching, so flush.
        self.draft.bump_version()

    @property
    def num_pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def num_active(self) -> int:
        return len(self._active)

    @torch.no_grad()
    def step(self) -> bool:
        """One admit → decode → select → retire iteration. Returns False
        when there was nothing to do (idle engine)."""
        # Site "serve/step": a delay here models a straggling iteration
        # (deadline pressure); a raise reaches the driver before any
        # state mutates, so the engine stays consistent.
        faults.fire("serve/step")
        if self.scfg.enforce_deadlines:
            self._abort_expired()
        self._admit()
        if not self._active:
            # Not necessarily idle: if every request admitted this round
            # was terminated (poisoned prefill), the queue may still hold
            # work — report it so run() keeps driving. With no active
            # lanes all resources are free, so the next _admit always
            # makes progress.
            return self.num_pending > 0
        if self.scfg.spec_decode:
            self._spec_decode_and_retire()
        else:
            self._ensure_capacity({})
            if self._active:
                self._decode_and_retire()
        return True

    def run(self) -> None:
        """Drive until queue and in-flight batch are empty."""
        while self.step():
            pass

    def stream(self, handle: ResultStream):
        """Yield ``handle``'s tokens as they are produced, stepping the
        engine as needed (single-consumer streaming API)."""
        sent = 0
        while True:
            while sent < len(handle.tokens):
                yield handle.tokens[sent]
                sent += 1
            if handle.done:
                return
            if not self.step():
                raise RuntimeError("engine idle but request not finished")

    @torch.no_grad()
    def warm_prefill_buckets(self, prompt_lens) -> int:
        """Launch every (rows, padded-length) batched-prefill shape that
        admission can hit for prompts drawn from ``prompt_lens`` — the
        same bucketing ``_flush_prefill`` applies, kept here so benchmark
        warmups cannot drift from it (the port compiles nothing per shape;
        the launches warm the allocator and the library's kernels). The
        probe rows are zero-length: their writes route to the sink page,
        so nothing real lands in the arena. Returns the number of shapes
        launched.
        """
        pool = self.pool
        shapes = sorted({self._prefill_shape(k, int(pl))
                         for k in range(1, self.scfg.n_slots + 1)
                         for pl in prompt_lens})
        for r, s in shapes:
            _, new_cache = self._prefill(
                self.params, np.zeros((r, s), np.int32),
                np.zeros((r,), np.int32),
                np.full((r,), pool.n_lanes, np.int32), pool.cache,
                np.full((r, pool.max_pages), pool.sink, np.int32))
            pool.swap_cache(new_cache)
        return len(shapes)

    def health(self) -> dict:
        """Cheap liveness/readiness snapshot (the /healthz payload and
        ``stats()["health"]``). ``ready`` is the /readyz gate: the first
        prefill/decode launch is done (before that a request would stall
        on the kernels' build on the card) and the queue is below the
        shed threshold (an engine that would shed the next submit is not
        ready for more traffic)."""
        qd = self.num_pending
        return {
            "compiled": self._compiled,
            "queue_depth": qd,
            "active": len(self._active),
            "pages_free": self.pool.num_free_pages,
            "lanes_free": self.pool.num_free_lanes,
            "shed": self.shed_count,
            "poisoned": self.poisoned_count,
            "deadline_aborts": self.deadline_aborts,
            "deadline_misses": self.deadline_misses,
            "ready": bool(self._compiled
                          and (not self.scfg.max_queue
                               or qd < self.scfg.max_queue)),
        }

    def stats(self) -> dict:
        """Engine snapshot: the pre-obs keys (unchanged, for compat) plus
        the registry view — ``latency`` carries per-request histograms
        (admission-wait, TTFT, total; count/mean/p50/p95/p99 derived from
        the same perf_counter timestamps the handles expose raw) and
        ``metrics`` is the full ``repro_torch.obs`` snapshot, including the
        ``serve/phase/*`` span timings."""
        pool = self.pool
        # Internal fragmentation: the tail of each active request's last
        # page holds positions it has not reached (and with upfront
        # reservation, whole unreached pages). 0 = every mapped byte
        # corresponds to a written position.
        mapped_pos = pool.num_mapped_pages * pool.page_len
        used_pos = sum(st.cache_pos for st in self._active.values())
        # Admission-time reservation accounting: pages a lane maps but has
        # not written into yet (whole pages past ceil(cache_pos/page_len)).
        # Under worst-case reservation this is the fragmentation the
        # "ondemand" growth policy exists to reclaim; reporting it apart
        # from pages_in_use keeps the occupancy gauges meaningful.
        reserved_unwritten = sum(
            max(0, len(pool.lane_pages(slot))
                - -(-st.cache_pos // pool.page_len))
            for slot, st in self._active.items())
        out = {
            "completed": self.completed_count,
            "decode_steps": self.decode_steps,
            "prefill_calls": self.prefill_calls,
            "descent_skips": self.descent_skips,
            # The honest amortization metric: the fraction of decode steps
            # whose tree descent was actually skipped (a partial-hit step
            # still descends, even though its lookups count as cache hits).
            "descent_skip_rate": (self.descent_skips / self.decode_steps
                                  if self.decode_steps else 0.0),
            "mean_occupancy": (self._occupancy_sum / self.decode_steps
                               if self.decode_steps else 0.0),
            "n_slots": self.scfg.n_slots,
            "peak_active": self.peak_active,
            # -- paged-pool memory accounting --
            "n_pages": pool.n_pages,
            "page_len": pool.page_len,
            "pages_in_use": pool.num_mapped_pages,
            "pages_reserved_unwritten": reserved_unwritten,
            "pages_cached": pool.num_cached_pages,
            "pages_free": pool.num_free_pages,
            "peak_pages_in_use": self.peak_pages_in_use,
            "page_occupancy": pool.num_mapped_pages / pool.n_pages,
            "mean_page_occupancy": (
                self._page_occupancy_sum / (self.decode_steps
                                            * pool.n_pages)
                if self.decode_steps else 0.0),
            "internal_fragmentation": (1.0 - used_pos / mapped_pos
                                       if mapped_pos else 0.0),
            # Device bytes of this process's arena: under a mesh a rank's
            # part (KV heads split over ``model``).
            "arena_bytes_this_rank": pool.arena_bytes,
        }
        out["latency"] = {
            "admission_wait": self._h_admission.snapshot(),
            "ttft": self._h_ttft.snapshot(),
            "total": self._h_latency.snapshot(),
        }
        out["tokens"] = self._c_tokens.value
        if self.candidate_cache is not None:
            cc = self.candidate_cache.stats()
            out["candidate_cache"] = cc
            lookups = cc["hits"] + cc["misses"]
            self.registry.gauge("serve/candidate_cache_hit_rate").set(
                cc["hits"] / lookups if lookups else 0.0)
        if self.prefix_index is not None:
            hit_rate = (self.share_hits / self.share_lookups
                        if self.share_lookups else 0.0)
            out["prefix"] = {
                "lookups": self.share_lookups,
                "hits": self.share_hits,
                "hit_rate": hit_rate,
                "pages_reused": self.shared_pages_reused,
                "prefill_tokens_saved": self.prefill_tokens_saved,
                "cow_copies": self.cow_copies,
                "evictions": self.trie_evictions,
                "trie_nodes": self.prefix_index.n_nodes,
                "trie_tails": self.prefix_index.n_tails,
            }
            self.registry.gauge("serve/prefix_hit_rate").set(hit_rate)
            self.registry.gauge("serve/pages_cached").set(
                pool.num_cached_pages)
        if self.scfg.spec_decode:
            mean_acc = (self.drafts_accepted / self.verify_steps
                        if self.verify_steps else 0.0)
            out["spec"] = {
                "verify_steps": self.verify_steps,
                "drafts_proposed": self.drafts_proposed,
                "drafts_accepted": self.drafts_accepted,
                "mean_accepted": mean_acc,
                # tokens emitted per launch = accepted + the bonus token
                "mean_emitted_per_step": 1.0 + mean_acc,
            }
            store = getattr(self.draft, "store", None)
            if store is not None:
                out["spec"]["draft_store"] = {
                    "hits": store.hits, "misses": store.misses,
                    "entries": len(store._map)}
            self.registry.gauge("serve/spec_mean_accepted").set(mean_acc)
        out["health"] = self.health()
        out["sched"] = {
            "preemptions": self.preemptions,
            "restores": self.restores,
            "page_grows": self.page_grows,
            "deadline_misses": self.deadline_misses,
            "page_growth": self.scfg.page_growth,
            "per_class_latency": {pri: hist.snapshot()
                                  for pri, hist in
                                  sorted(self._class_hists.items())},
        }
        self.registry.gauge("serve/preemptions").set(self.preemptions)
        # Scheduler counters stay plain attributes (benchmarks reset the
        # peaks between warmup and the measured trace); the registry view
        # mirrors them at snapshot time.
        for name, v in (("serve/decode_steps", self.decode_steps),
                        ("serve/prefill_calls", self.prefill_calls),
                        ("serve/descent_skips", self.descent_skips),
                        ("serve/completed", self.completed_count),
                        ("serve/peak_active", self.peak_active)):
            self.registry.gauge(name).set(v)
        out["metrics"] = self.registry.snapshot()
        return out

    # -- scheduler internals --------------------------------------------

    def _terminate(self, h: ResultStream, status: str, now: float) -> None:
        """Terminal non-"ok" path shared by deadline aborts and poison
        isolation: reclaim the lane + pages if held, mark the handle
        done, keep the audit counters honest. Refcounted shared pages
        drop through ``pool.release`` exactly as a normal retirement
        would, so an abort can never strand a page (the chaos suite's
        no-leak invariant)."""
        if h.slot is not None:
            self._active.pop(h.slot, None)
            self.pool.release(h.slot)
            h.slot = None
        h._spill = None
        h.status = status
        h.done = True
        h.finished_at = now
        if status == "deadline":
            self.deadline_aborts += 1
            self.deadline_misses += 1
            self.registry.counter("serve/deadline_aborts").inc()
        elif status == "error":
            self.poisoned_count += 1
            self.registry.counter("serve/poisoned").inc()
        self.completed.append(h)
        if self.exporter is not None:
            self.exporter.emit({
                "event": "request", "request_id": h.request_id,
                "tokens": len(h.tokens), "priority": h.priority,
                "status": status,
                "admission_wait_s": (h.admitted_at - h.submitted_at
                                     if h.admitted_at is not None
                                     else None),
                "ttft_s": (h.first_token_at - h.submitted_at
                           if h.first_token_at is not None else None),
                "latency_s": h.finished_at - h.submitted_at})

    def _abort_expired(self) -> None:
        """Wall-clock deadline enforcement (``enforce_deadlines``):
        queued requests past ``deadline_s`` are rejected before wasting
        a prefill; running lanes past theirs are aborted mid-decode,
        reclaiming lane + pages for requests that can still make their
        SLA. Requests without a deadline are untouched."""
        now = self._now()

        def expired(h: ResultStream) -> bool:
            return (h.request.deadline_s is not None
                    and now - h.submitted_at > h.request.deadline_s)

        for pri in list(self._queues):
            q = self._queues[pri]
            kept: "deque[ResultStream]" = deque()
            while q:
                h = q.popleft()
                if expired(h):
                    self._terminate(h, "deadline", now)
                else:
                    kept.append(h)
            if kept:
                self._queues[pri] = kept
            else:
                del self._queues[pri]
        for slot in list(self._active):
            st = self._active[slot]
            if expired(st):
                self._terminate(st, "deadline", now)

    def _admit(self) -> None:
        """Class-ordered admission: scan SLA classes high→low, FIFO within
        a class, and a blocked class blocks everything below it (no
        sneaking past a starved interactive request). Head-of-line order
        *within* a class is preserved unconditionally (a request is never
        skipped in favour of a later one, even when a later, smaller
        request would fit the remaining pages) — the fairness property the
        tests pin down; single-class traffic reproduces the old global
        FIFO exactly.

        Per request, resources come in escalating order: free pages →
        eviction of cached prefix pages (LRU leaf-first) → preemption of
        strictly-lower-class lanes (spill-and-restore). Prompts (or, with
        sharing, their unmatched suffixes) are prefilled in one padded
        batched call (or one call per request with
        ``batched_prefill=False`` — same bytes out, oracle-tested).
        """
        batch: List[ResultStream] = []        # legacy full-prompt prefill
        suffix_jobs: List[ResultStream] = []  # sharing-path prefill
        admitted: List[ResultStream] = []
        for pri in sorted(self._queues, reverse=True):
            q = self._queues[pri]
            while q:
                if not self._try_admit(q[0], batch, suffix_jobs, admitted):
                    break
                q.popleft()
            if q:
                break
        for pri in [p for p, q in self._queues.items() if not q]:
            del self._queues[pri]
        if batch:
            self._prefill_batch(batch)
        if suffix_jobs:
            self._flush_suffix_prefill(suffix_jobs)
        self._finish_admission(admitted)
        self.peak_active = max(self.peak_active, len(self._active))
        self.peak_pages_in_use = max(self.peak_pages_in_use,
                                     self.pool.num_mapped_pages)
        self._g_queue.set(self.num_pending)
        self._g_active.set(len(self._active))
        self._g_pages.set(self.pool.num_mapped_pages / self.pool.n_pages)

    def _try_admit(self, h: ResultStream, batch: List[ResultStream],
                   suffix_jobs: List[ResultStream],
                   admitted: List[ResultStream]) -> bool:
        """Admit one head-of-class request if its resources can be found
        (free → evict cached → preempt lower classes), else False."""
        pool, scfg = self.pool, self.scfg
        match = None
        counted_lookup = False
        while True:
            if h._spill is not None:
                need = h._spill.n_pages       # exact resume footprint
                free_needed = need
            else:
                prompt = h.request.prompt
                # "reserve": worst-case pages up front (a request admitted
                # is a request that finishes). "ondemand": admit on pages
                # for the prompt + first decode write; grow at boundaries.
                horizon = (prompt.size + h.request.max_new_tokens
                           if scfg.page_growth == "reserve"
                           else prompt.size + 1)
                need = pool.pages_needed(horizon)
                if self.prefix_index is not None:
                    match = self.prefix_index.match(prompt)
                    if not counted_lookup:
                        self.share_lookups += 1
                        counted_lookup = True
                # A matched COW tail still consumes one free page (the
                # private copy) — only its *prefill* is saved, not the
                # byte; matched full pages are pure savings.
                free_needed = need - (len(match.pages) if match else 0)
            if pool.num_free_lanes >= 1 and \
                    pool.num_free_pages >= free_needed:
                break
            if (self.prefix_index is not None
                    and self.prefix_index.evict_lru(pool)):
                # Re-match after every eviction: the LRU choice may have
                # pruned part of our own matched path.
                self.trie_evictions += 1
                continue
            if scfg.preemption and self._preempt_one(h.priority):
                continue
            return False

        if h._spill is not None:
            lane, _pages = pool.restore(h._spill)
            h._spill = None
            h.slot = lane
            self.restores += 1
            admitted.append(h)
            return True

        prompt = h.request.prompt
        if match is not None and (match.pages
                                  or match.tail_page is not None):
            shared = list(match.pages)
            tail_idx = None
            if match.tail_page is not None:
                tail_idx = len(shared)
                shared.append(match.tail_page)
            lane, _priv = pool.alloc_shared(shared, need - len(shared))
            if tail_idx is not None:
                pool.cow(lane, tail_idx)
                self.cow_copies += 1
            covered = match.tokens_matched + match.tail_len
            self.share_hits += 1
            self.shared_pages_reused += len(shared)
            self.prefill_tokens_saved += covered
        else:
            lane, _pages = pool.alloc(need)
            covered = 0
        h.slot = lane
        h.cache_pos = int(prompt.size)
        h.next_input = int(prompt[-1])
        h.history = [int(t) for t in prompt]
        h._suffix_start = covered
        if self.prefix_index is not None:
            if covered < prompt.size:
                suffix_jobs.append(h)
                if not scfg.batched_prefill:
                    self._flush_suffix_prefill(suffix_jobs)
                    suffix_jobs.clear()
        else:
            batch.append(h)
            if not scfg.batched_prefill:
                self._prefill_batch(batch)
                batch.clear()
        admitted.append(h)
        return True

    def _finish_admission(self, admitted: List[ResultStream]) -> None:
        """Post-flush bookkeeping, in admission order. Runs after the
        prefill launches so trie registration only ever exposes pages
        whose KV bytes are already valid."""
        now = self._now()
        for h in admitted:
            if h.done:
                continue        # failed in isolation during its prefill
            if h.admitted_at is None:       # first admission only
                h.admitted_at = now
                self._h_admission.observe(now - h.submitted_at)
            h.admitted_seq = self._admit_seq
            self._admit_seq += 1
            self.admission_order.append(h.request_id)
            self._active[h.slot] = h
            if (self.prefix_index is not None and not h.tokens
                    and h.cache_pos == h.request.prompt.size):
                self.prefix_index.insert(
                    h.request.prompt, self.pool.lane_pages(h.slot),
                    self.pool)

    def _spill_to_queue(self, st: ResultStream) -> None:
        """Preempt a running lane: device→host byte image of its pages +
        lane rows, release everything, requeue at the FRONT of its class
        (it lost its turn through no fault of its own). Restore is
        byte-exact, so the request's output is unchanged."""
        st._spill = self.pool.spill(st.slot)
        self.pool.release(st.slot)
        del self._active[st.slot]
        st.slot = None
        st.preempted += 1
        self.preemptions += 1
        self._queues.setdefault(st.priority, deque()).appendleft(st)

    def _preempt_one(self, above: int) -> bool:
        """Spill the youngest-admitted lane of strictly lower class than
        ``above``. Youngest first: it has the least sunk prefill/decode
        work and the shortest spill image on average."""
        victims = [st for st in self._active.values()
                   if st.priority < above]
        if not victims:
            return False
        self._spill_to_queue(max(victims, key=lambda s: s.admitted_seq))
        return True

    def _ensure_capacity(self, extra: Dict[int, int]) -> None:
        """On-demand page growth: before a decode/verify launch, every
        active lane must map pages covering its write positions this step
        (``cache_pos .. cache_pos + extra[slot]``). Escalation mirrors
        admission (grow → evict cached → preempt lower → spill *self*);
        a lane spilled here simply sits out the step and resumes
        byte-exact later. No-op under the "reserve" policy."""
        if self.scfg.page_growth != "ondemand":
            return
        pool = self.pool
        for slot in list(self._active):
            st = self._active.get(slot)
            if st is None:
                continue                    # preempted by an earlier lane
            need = pool.pages_needed(st.cache_pos + extra.get(slot, 0) + 1)
            while len(pool.lane_pages(slot)) < need:
                if pool.grow(slot, need - len(pool.lane_pages(slot))):
                    self.page_grows += 1
                    break
                if (self.prefix_index is not None
                        and self.prefix_index.evict_lru(pool)):
                    self.trie_evictions += 1
                    continue
                if self.scfg.preemption and self._preempt_one(st.priority):
                    continue
                self._spill_to_queue(st)
                break

    @staticmethod
    def _bucket(n: int) -> int:
        """Next power of two >= n: bounds the distinct (rows, length)
        shapes the batched prefill launches."""
        b = 1
        while b < n:
            b *= 2
        return b

    def _prefill_shape(self, n_handles: int, s_max: int):
        """THE (rows, padded-length) shape admission uses for a group
        of ``n_handles`` prompts up to ``s_max`` long — shared by
        ``_flush_prefill`` and ``warm_prefill_buckets`` so warmups launch
        exactly the shapes the engine will launch. Attn prompts pad to a
        power of two (causality keeps padding invisible); ssm/hybrid run
        at exact length (recurrent state is not padding-invariant)."""
        n_rows = min(self._bucket(n_handles), self.pool.n_lanes)
        s_pad = self._bucket(s_max) if self.cfg.block == "attn" else s_max
        return n_rows, s_pad

    def _prefill_batch(self, handles: List[ResultStream]) -> None:
        """Batched prefill for ``handles``: rows bucketed to a power of two
        (padding rows scatter into the sink page / drop their lane writes),
        prompts right-padded to a power-of-two length (causal attention
        keeps padding invisible to the real tokens).

        Length padding is only sound for pure-attention models: K/V are
        position-local, so padded positions land in the sink page and the
        real rows' bytes are untouched. An SSM branch carries a *recurrent*
        state out of the prefill, and padding tokens would keep updating it
        past the prompt — so ssm/hybrid admissions are grouped by exact
        prompt length (still one call per group, just no length padding).
        """
        if self.cfg.block != "attn" and len(handles) > 1:
            by_len: Dict[int, List[ResultStream]] = {}
            for h in handles:
                by_len.setdefault(h.request.prompt.size, []).append(h)
            for group in by_len.values():
                self._flush_prefill(group)
        else:
            self._flush_prefill(handles)
        # Admission bookkeeping (SUBMISSION order, independent of flush
        # grouping) happens in _finish_admission after every launch.

    def _screen_poison(self, handles: List[ResultStream]
                       ) -> List[ResultStream]:
        """Site "serve/prefill": one invocation per request entering a
        prefill launch, so an injected raise fails exactly one request —
        the handle is terminated with status="error", its lane + pages
        reclaimed, and the rest of the batch proceeds."""
        if faults.active() is None:
            return handles
        ok = []
        for h in handles:
            try:
                faults.fire("serve/prefill")
                ok.append(h)
            except Exception:
                self._terminate(h, "error", self._now())
        return ok

    def _flush_prefill(self, handles: List[ResultStream]) -> None:
        handles = self._screen_poison(handles)
        if not handles:
            return
        try:
            self._launch_prefill(handles)
        except Exception:
            if len(handles) == 1:
                self._terminate(handles[0], "error", self._now())
                return
            # Poison isolation: the batched launch raised — re-run one
            # request per launch so only the raiser fails and the rest
            # of the batch prefills normally.
            for h in handles:
                self._flush_prefill([h])

    def _launch_prefill(self, handles: List[ResultStream]) -> None:
        pool = self.pool
        n_rows, s_pad = self._prefill_shape(
            len(handles), max(h.request.prompt.size for h in handles))
        tokens = np.zeros((n_rows, s_pad), np.int32)
        lengths = np.zeros((n_rows,), np.int32)
        lanes = np.full((n_rows,), pool.n_lanes, np.int32)  # OOB => drop
        ptab = np.full((n_rows, pool.max_pages), pool.sink, np.int32)
        for i, h in enumerate(handles):
            prompt = h.request.prompt
            tokens[i, :prompt.size] = prompt
            lengths[i] = prompt.size
            lanes[i] = h.slot
            ptab[i] = pool.page_table[h.slot]
        with span("serve/phase/prefill", self.registry):
            hid, new_cache = self._prefill(self.params, tokens, lengths,
                                           lanes, pool.cache, ptab)
            del hid   # first output token comes from the decode step,
            #           matching the lock-step path token-for-token
            pool.swap_cache(new_cache)
        self.prefill_calls += 1
        self._compiled = True

    def _flush_suffix_prefill(self, handles: List[ResultStream]) -> None:
        """Sharing-path prefill: each admitted prompt runs only its
        UNMATCHED suffix through the paged multi-token step — attention
        gathers the shared prefix pages through the lane's page table, so
        the suffix K/V comes out byte-identical to a full prefill while
        the matched tokens' compute and writes are skipped entirely.
        Rows and lengths pad to powers of two; padded rows carry an
        all-sink page table and zero length (writes routed to the sink).
        """
        handles = self._screen_poison(handles)
        pool = self.pool
        jobs = [h for h in handles
                if h._suffix_start < h.request.prompt.size]
        if not jobs:
            return                  # fully-matched prompts: nothing to run
        try:
            self._launch_suffix_prefill(jobs)
        except Exception:
            if len(jobs) == 1:
                self._terminate(jobs[0], "error", self._now())
                return
            for h in jobs:          # poison isolation, as in the full path
                self._flush_suffix_prefill([h])

    def _launch_suffix_prefill(self, jobs: List[ResultStream]) -> None:
        pool = self.pool
        n_rows = self._bucket(len(jobs))
        s_pad = self._bucket(max(h.request.prompt.size - h._suffix_start
                                 for h in jobs))
        tokens = np.zeros((n_rows, s_pad), np.int32)
        start = np.zeros((n_rows,), np.int32)
        lengths = np.zeros((n_rows,), np.int32)
        ptab = np.full((n_rows, pool.max_pages), pool.sink, np.int32)
        for i, h in enumerate(jobs):
            suffix = h.request.prompt[h._suffix_start:]
            tokens[i, :suffix.size] = suffix
            start[i] = h._suffix_start
            lengths[i] = suffix.size
            ptab[i] = pool.page_table[h.slot]
        with span("serve/phase/prefill", self.registry):
            hid, new_cache = self._paged_prefill(
                self.params, tokens, start, lengths, pool.cache, ptab)
            del hid   # first output token comes from the decode step
            pool.swap_cache(new_cache)
        self.prefill_calls += 1
        self._compiled = True

    def _decode_and_retire(self) -> None:
        n = self.scfg.n_slots
        token = np.zeros((n, 1), np.int32)
        pos = np.zeros((n,), np.int32)
        for slot, st in self._active.items():
            token[slot, 0] = st.next_input
            pos[slot] = st.cache_pos
        with span("serve/phase/decode", self.registry):
            h, new_cache = self._decode(self.params, token, self.pool.cache,
                                        pos, self.pool.page_table)
            self.pool.swap_cache(new_cache)
        self._compiled = True
        self.decode_steps += 1
        self._occupancy_sum += len(self._active)
        self._page_occupancy_sum += self.pool.num_mapped_pages

        with span("serve/phase/select", self.registry):
            next_tokens = self._select(h)

        now = self._now()
        n_live = len(self._active)
        for slot in list(self._active):
            st = self._active[slot]
            self._emit_token(slot, st, int(next_tokens[slot]), now)
        self._c_tokens.inc(n_live)
        self._post_step_metrics()

    def _emit_token(self, slot: int, st: ResultStream, tok: int,
                    now: float) -> bool:
        """Append one generated token and retire the request when any
        stop condition fires (the same checks, in the same order, as the
        lock-step oracle). Returns True when the request retired."""
        if st.first_token_at is None:
            st.first_token_at = now
            self._h_ttft.observe(now - st.submitted_at)
        st.tokens.append(tok)
        st.history.append(tok)
        st.next_input = tok
        st.cache_pos += 1
        done = (len(st.tokens) >= st.request.max_new_tokens
                or (st._eos is not None and tok == st._eos)
                or st.cache_pos >= self.scfg.max_len)
        if done:
            st.done = True
            st.finished_at = now
            del self._active[slot]
            self.pool.release(slot)
            self.completed.append(st)
            self.completed_count += 1
            latency = st.finished_at - st.submitted_at
            self._h_latency.observe(latency)
            self._class_hist(st.priority).observe(latency)
            if (st.request.deadline_s is not None
                    and latency > st.request.deadline_s):
                self.deadline_misses += 1
            if self.exporter is not None:
                self.exporter.emit({
                    "event": "request", "request_id": st.request_id,
                    "tokens": len(st.tokens), "priority": st.priority,
                    "preempted": st.preempted,
                    "admission_wait_s": (st.admitted_at
                                         - st.submitted_at),
                    "ttft_s": st.first_token_at - st.submitted_at,
                    "latency_s": latency})
        return done

    def _class_hist(self, priority: int):
        h = self._class_hists.get(priority)
        if h is None:
            h = self.registry.histogram(f"serve/latency_s/class_{priority}")
            self._class_hists[priority] = h
        return h

    def _post_step_metrics(self) -> None:
        self._g_active.set(len(self._active))
        self._g_pages.set(self.pool.num_mapped_pages / self.pool.n_pages)
        if (self.exporter is not None
                and self.decode_steps % self.metrics_interval == 0):
            self.exporter.emit({
                "event": "serve_step", "engine_step": self.decode_steps,
                "queue_depth": self.num_pending,
                "active": len(self._active),
                "page_occupancy": (self.pool.num_mapped_pages
                                   / self.pool.n_pages)})

    def _spec_decode_and_retire(self) -> None:
        """Speculative step: draft → one batched multi-token verify →
        exact accept/reject → retire.

        Each lane's verify chain is ``[y_last, d1..dk]`` fed at positions
        ``cache_pos .. cache_pos+k``; the target model's own greedy choice
        at every chain position comes out of ONE launch. Acceptance is the
        longest draft prefix that matches those choices, plus the bonus
        token — the emitted tokens are exactly the lock-step sequence, so
        speculation changes wall-clock only, never bytes (oracle-tested).
        K/V written for rejected positions is dead on arrival: the next
        step's writes land on top of it before causality can expose it.
        """
        scfg, pool = self.scfg, self.pool
        drafts: Dict[int, List[int]] = {}
        for slot, st in self._active.items():
            # k is capped so the LAST chain write stays inside the
            # request's budget: cache_pos+k <= prompt+max_new-1 (and the
            # max_len retirement bound the oracle also respects).
            cap = min(scfg.max_draft,
                      st.request.max_new_tokens - len(st.tokens) - 1,
                      scfg.max_len - 1 - st.cache_pos)
            d = self.draft.propose(tuple(st.history), cap) if cap > 0 \
                else []
            drafts[slot] = [int(t) for t in d[:max(cap, 0)]]
        self._ensure_capacity({s: len(d) for s, d in drafts.items()})
        if not self._active:
            return                      # capacity pressure spilled everyone
        k_max = max(len(drafts[s]) for s in self._active)
        s_pad = self._bucket(k_max + 1)
        n = scfg.n_slots
        tokens = np.zeros((n, s_pad), np.int32)
        start = np.zeros((n,), np.int32)
        lengths = np.zeros((n,), np.int32)
        ptab = np.full((n, pool.max_pages), pool.sink, np.int32)
        for slot, st in self._active.items():
            chain = [st.next_input] + drafts[slot]
            tokens[slot, :len(chain)] = chain
            start[slot] = st.cache_pos
            lengths[slot] = len(chain)
            ptab[slot] = pool.page_table[slot]
        with span("serve/phase/decode", self.registry):
            h, new_cache = self._paged_prefill(self.params, tokens, start,
                                               lengths, pool.cache, ptab)
            pool.swap_cache(new_cache)
        self.decode_steps += 1
        self.verify_steps += 1
        self._occupancy_sum += len(self._active)
        self._page_occupancy_sum += pool.num_mapped_pages

        with span("serve/phase/select", self.registry):
            sel = self._select(h, multi=True)               # (n, s_pad)

        now = self._now()
        emitted = 0
        for slot in list(self._active):
            st = self._active[slot]
            d = drafts[slot]
            self.drafts_proposed += len(d)
            a = 0
            while a < len(d) and d[a] == int(sel[slot, a]):
                a += 1
            self.drafts_accepted += a
            for j in range(a + 1):
                tok = int(sel[slot, j])
                # Feed the tree's own (possibly stale-feature) choice
                # back to the draft source: next time this context
                # repeats, the whole continuation replays as the draft.
                self.draft.observe(tuple(st.history), tok)
                emitted += 1
                if self._emit_token(slot, st, tok, now):
                    break
        self._c_tokens.inc(emitted)
        self._post_step_metrics()

    def _select(self, h, multi: bool = False) -> np.ndarray:
        """Next-token selection for every slot (free rows give garbage that
        the caller never reads), as a host array. ``multi=True`` selects at
        EVERY position of a (B, S, d) verify step — the head path (dense
        scores, beam descent, re-scoring) is row-local over leading batch
        dims, so the per-position choices are bitwise the single-token ones.
        The candidate cache is bypassed in that mode (it keys whole-prefix
        single steps; skipping it can only cost duplicate descent work,
        never change a result)."""
        if not self.beam:
            return self._select_dense(self.params, self.head_state,
                                      h).cpu().numpy()

        cache = None if multi else self.candidate_cache
        cached: Dict[int, Any] = {}
        if cache is not None:
            for slot, st in self._active.items():
                cached[slot] = cache.get(tuple(st.history))
        all_hit = (cache is not None and self._active
                   and all(v is not None for v in cached.values()))
        if all_hit:
            # Skip the tree descent entirely: assemble cached candidate
            # sets; free rows stay all-invalid (-1 / -inf).
            n = self.scfg.n_slots
            cand_np = np.full((n, self.beam), -1, np.int64)
            log_pn_np = np.full((n, self.beam), -np.inf, np.float32)
            for slot, (c, lp) in cached.items():
                cand_np[slot], log_pn_np[slot] = c, lp
            cand = torch.from_numpy(cand_np).to(self.device)
            log_pn = torch.from_numpy(log_pn_np).to(self.device)
            self.descent_skips += 1
        else:
            with span("serve/phase/descent", self.registry):
                cand, log_pn = self._propose(self.head_state, h)
            if cache is not None:
                # One host transfer for each array (they are tiny:
                # n_slots x beam ids + log-probs).
                cand_np, log_pn_np = cand.cpu().numpy(), log_pn.cpu().numpy()
                for slot, st in self._active.items():
                    if cached.get(slot) is None:
                        cache.put(tuple(st.history), cand_np[slot],
                                  log_pn_np[slot])
        return self._score(self.params, h, cand, log_pn).cpu().numpy()

