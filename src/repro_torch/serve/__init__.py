"""repro_torch.serve — the continuous-batching serving engine, the port
of ``repro.serve``.

Scheduler states (``engine.Engine``)::

    submit()            admit (priority class, FIFO)   retire
  ───────────▶ QUEUED ─────────────▶ RUNNING ─────────▶ FINISHED
                        lane+pages     │  ▲              lane + pages
                        = alloc(n);    └──┘              reclaimed,
                        batched        decode step       EOS / max-new /
                        prefill        (paged attention  max-len reached
                        into pages     through the
                                       page table)

The pool (``cache_pool.PagedPool``) owns one arena of fixed-size KV pages
plus a sink page, allocated once and updated in place. Admission
allocates a decode lane and its pages and prefills all newly admitted
prompts in one padded call (``train.step.make_batched_prefill``: the
lock-step prefill on a fresh contiguous cache, then one ``index_copy_``
into the arena). Decode writes each lane's token at ``(page_table[pos //
page_len], pos % page_len)`` and the ``flash_attention`` kernel reads the
lane's keys through its page table, without copying pages. The host-only
parts — the prefix trie (``prefix_index``), the candidate cache
(``candidate_cache``), the draft store (``spec``) and the traffic
generators (``traffic``, numpy only: the same seed gives the reference's
workloads) — are the port's own copies of the reference's.
"""
from repro_torch.serve.cache_pool import PagedPool, PageSpill
from repro_torch.serve.candidate_cache import CandidateCache
from repro_torch.serve.engine import (Engine, Request, ResultStream, ServeConfig,
                                lockstep_decode)
from repro_torch.serve.prefix_index import PrefixIndex
from repro_torch.serve.spec import ContinuationStore, NullDraft, ReplayDraft
from repro_torch.serve.traffic import (TrafficConfig, drive,
                                 make_heavy_tail_mix,
                                 make_shared_prefix_burst, make_workload)

__all__ = ["PagedPool", "PageSpill", "CandidateCache", "Engine", "Request",
           "ResultStream", "ServeConfig", "TrafficConfig", "drive",
           "lockstep_decode", "make_workload", "PrefixIndex",
           "ContinuationStore", "NullDraft", "ReplayDraft",
           "make_shared_prefix_burst", "make_heavy_tail_mix"]
