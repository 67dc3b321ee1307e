"""Paged KV-cache pool for continuous batching, with shared pages: the
port of ``repro.serve.cache_pool``. The host bookkeeping is the
reference's line for line; the arena is a pair of torch tensors updated in
place (the reference donates its arena to each jitted step; the port has
nothing to donate).

The pool owns ONE device cache dict, allocated once at engine start via
``transformer.init_paged_cache(cfg, n_lanes, n_pages + 1, page_len)``:
attention K/V leaves are a shared *arena* (L, n_pages + 1, page_len, ...)
of fixed-size pages (the extra physical page is the **sink** — the
designated garbage target for free lanes and padded prefill rows; one
page of deliberate overhead traded for simple, always-in-bounds
addressing). SSM conv/state leaves have no sequence dimension to page:
they stay lane-indexed (L, n_lanes, ...), and spill/restore carry a lane's
rows with it, byte for byte.

A request borrows two resources for its lifetime: a decode *lane* (a row of
the static decode batch) and some number of *pages*. A physical
page may back the same logical content in SEVERAL lanes at once (shared
prompt prefixes, DESIGN.md §12), so page lifetime is refcounted:

                     alloc / alloc_shared                release(lane)
  free ──────────────────────────────────▶ rc ≥ 1 ──────────────────────┐
  pages    retain() bumps rc per mapping      │ rc hits 0               │
    ▲                                         ▼                         │
    └───── unregister/evict ──────────── cached (rc == 0, registered    │
                                          by the prefix index; holds    │
                                          reusable prefix KV, evictable │
                                          on demand) ◀──────────────────┘
                                                  (registered pages only;
                                                   others free directly)

Free, live (rc > 0) and cached pages always partition ``range(n_pages)``.
``rc(p)`` equals the number of lanes whose page table maps ``p``; a lane
never maps the same page twice. Copy-on-write (`cow`) gives a lane a
private duplicate of a shared page — a device-side page copy plus a remap,
never a whole-arena reallocation (one ``index_copy_`` over all layers).
Preemption uses `spill` (device→host copy of the lane's pages into CPU
tensors) and `restore` (fresh alloc + exact byte scatter), so a preempted
request resumes bit-identical without re-running prefill. Stale bytes left in a reclaimed page are dead by
construction (causal masking above the next occupant's positions; prefill
overwrites below), so there is no host↔device traffic in steady state.

Bookkeeping is host-side and O(n_lanes + n_pages); the device arrays never
change shape. Invariants (enforced, and property-tested in
``tests/test_torch_serve_pool.py``): the free/live/cached partition, refcount
== number of mapping lanes, cached ⇔ (rc == 0 and registered), release
unrefs exactly the pages the lane mapped, and a drained, unregistered pool
is indistinguishable from a fresh one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

# Cache leaves indexed (L, page, offset, ...) — shareable / spillable by
# page. Everything else in the pytree is lane-indexed (L, lane, ...).
_PAGE_KEYS = ("k", "v")


@dataclasses.dataclass
class PageSpill:
    """Host-side byte image of one lane: its pages in logical order (CPU
    tensors of the arena's dtype). ``lane_rows`` holds the lane's rows of
    the lane-indexed SSM leaves (float32)."""
    n_pages: int
    pages: Dict[str, torch.Tensor]      # key -> (L, n_pages, page_len, ...)
    lane_rows: Dict[str, torch.Tensor]  # key -> (L, ...) single-lane rows

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.pages.values()) + \
            sum(a.numel() * a.element_size() for a in self.lane_rows.values())


class PagedPool:
    """Fixed arena of ``n_pages`` KV pages + ``n_lanes`` decode lanes with
    refcounted free-list allocation and per-lane page tables."""

    def __init__(self, cfg: ModelConfig, n_lanes: int, n_pages: int,
                 page_len: int, max_len: int, dtype=torch.float32,
                 device="cuda"):
        assert n_lanes >= 1 and n_pages >= 1 and page_len >= 1
        assert max_len >= 2
        self.n_lanes = n_lanes
        self.n_pages = n_pages
        self.page_len = page_len
        self.max_len = max_len
        # Worst-case pages a single request can map; fixes the page-table
        # width (and with it the gathered KV length) at compile time.
        self.max_pages = -(-max_len // page_len)
        assert n_pages >= self.max_pages, (
            f"pool of {n_pages} pages cannot hold one max_len={max_len} "
            f"request ({self.max_pages} pages of {page_len})")
        self.sink = n_pages               # physical garbage page
        self.dtype = dtype
        self.device = device_lib.resolve(device)
        self.cache = transformer.init_paged_cache(
            cfg, n_lanes, n_pages + 1, page_len, dtype=dtype,
            device=self.device)
        # LIFO free lists: recently retired lanes/pages are reused first
        # (warm in whatever memory tier the runtime keeps them in).
        self._free_pages: List[int] = list(range(n_pages - 1, -1, -1))
        self._free_lanes: List[int] = list(range(n_lanes - 1, -1, -1))
        self._pages_of: Dict[int, List[int]] = {}      # lane -> its pages
        self._refcount: Dict[int, int] = {}            # page -> #lanes
        # Pages pinned by the prefix index: when their refcount drops to 0
        # they park in ``_cached`` (KV bytes intact, evictable) instead of
        # returning to the free list.
        self._registered: set = set()
        self._cached: set = set()
        # Host mirror of the device page tables, fed to every decode step.
        # Unmapped entries point at the sink page.
        self.page_table = np.full((n_lanes, self.max_pages), self.sink,
                                  np.int32)

    # -- allocation ------------------------------------------------------

    def pages_needed(self, total_len: int) -> int:
        """Pages covering ``total_len`` positions (prompt + max new)."""
        return max(1, -(-int(total_len) // self.page_len))

    @property
    def num_free_pages(self) -> int:
        return len(self._free_pages)

    @property
    def num_cached_pages(self) -> int:
        return len(self._cached)

    @property
    def num_mapped_pages(self) -> int:
        """Pages live in at least one lane (rc > 0)."""
        return self.n_pages - len(self._free_pages) - len(self._cached)

    @property
    def num_free_lanes(self) -> int:
        return len(self._free_lanes)

    @property
    def num_in_use(self) -> int:
        return self.n_lanes - len(self._free_lanes)

    def can_admit(self, n_pages: int) -> bool:
        return bool(self._free_lanes) and len(self._free_pages) >= n_pages

    def can_admit_evicting(self, n_pages: int) -> bool:
        """Admissible if cached (evictable) pages were reclaimed first."""
        return bool(self._free_lanes) and \
            len(self._free_pages) + len(self._cached) >= n_pages

    def lane_pages(self, lane: int) -> List[int]:
        """The lane's pages in logical order (shared prefix first)."""
        return list(self._pages_of[lane])

    def refcount(self, page: int) -> int:
        return self._refcount.get(page, 0)

    def is_cached(self, page: int) -> bool:
        """rc == 0 but bytes kept for the prefix index (evictable)."""
        return page in self._cached

    def _take_free(self, n: int) -> List[int]:
        pages = [self._free_pages.pop() for _ in range(n)]
        for p in pages:
            assert self._refcount.get(p, 0) == 0
            self._refcount[p] = 1
        return pages

    def _unref(self, page: int) -> None:
        rc = self._refcount[page] - 1
        assert rc >= 0, f"page {page} over-released"
        if rc:
            self._refcount[page] = rc
            return
        del self._refcount[page]
        if page in self._registered:
            self._cached.add(page)        # prefix KV kept warm, evictable
        else:
            self._free_pages.append(page)

    def retain(self, page: int) -> None:
        """Bump a page's refcount for one more mapping lane. Revives
        cached pages (rc 0 → 1) without touching their bytes."""
        assert 0 <= page < self.n_pages
        if page in self._cached:
            self._cached.remove(page)
            assert page not in self._refcount
            self._refcount[page] = 1
        else:
            assert self._refcount.get(page, 0) > 0, (
                f"retain of free page {page}")
            self._refcount[page] += 1

    def _assign_lane(self, pages: List[int]) -> int:
        lane = self._free_lanes.pop()
        assert lane not in self._pages_of, f"lane {lane} double-assigned"
        self._pages_of[lane] = pages
        row = self.page_table[lane]
        row[:] = self.sink
        row[:len(pages)] = pages
        return lane

    def alloc(self, n_pages: int) -> Optional[Tuple[int, List[int]]]:
        """Borrow one lane plus ``n_pages`` fresh pages, or None when
        either resource is exhausted (all-or-nothing: no partial grants)."""
        assert 1 <= n_pages <= self.max_pages, n_pages
        if not self.can_admit(n_pages):
            return None
        pages = self._take_free(n_pages)
        return self._assign_lane(pages), pages

    def alloc_shared(self, shared: Sequence[int], n_private: int,
                     ) -> Optional[Tuple[int, List[int]]]:
        """Borrow one lane mapping ``shared`` (already-live or cached
        pages, refcounts bumped — their KV bytes are reused as-is) followed
        by ``n_private`` fresh pages. Returns (lane, private_pages)."""
        n_total = len(shared) + n_private
        assert 1 <= n_total <= self.max_pages, (len(shared), n_private)
        assert len(set(shared)) == len(shared), "duplicate shared page"
        if not self._free_lanes or len(self._free_pages) < n_private:
            return None
        for p in shared:
            self.retain(p)
        private = self._take_free(n_private)
        lane = self._assign_lane(list(shared) + private)
        return lane, private

    def grow(self, lane: int, n_new: int) -> Optional[List[int]]:
        """Append ``n_new`` fresh pages to a live lane (on-demand page
        growth at a page boundary). None if the free list is short."""
        assert lane in self._pages_of
        have = self._pages_of[lane]
        assert len(have) + n_new <= self.max_pages, (len(have), n_new)
        if len(self._free_pages) < n_new:
            return None
        pages = self._take_free(n_new)
        row = self.page_table[lane]
        row[len(have):len(have) + n_new] = pages
        have.extend(pages)
        return pages

    def release(self, lane: int) -> List[int]:
        """Return the lane and unref exactly its pages. Pages whose
        refcount hits 0 go to the free list, or park as cached when the
        prefix index has them registered."""
        assert 0 <= lane < self.n_lanes
        assert lane in self._pages_of, f"lane {lane} released while free"
        pages = self._pages_of.pop(lane)
        for p in pages:
            self._unref(p)
        self._free_lanes.append(lane)
        self.page_table[lane] = self.sink
        return pages

    # -- prefix-index registration --------------------------------------

    def register(self, pages: Sequence[int]) -> None:
        """Pin pages in the prefix index: on last unref they become
        cached (bytes kept, evictable) instead of free."""
        for p in pages:
            assert 0 <= p < self.n_pages
            assert self._refcount.get(p, 0) > 0 or p in self._cached, (
                f"registering free page {p}")
            self._registered.add(p)

    def unregister(self, pages: Sequence[int]) -> None:
        """Drop the prefix-index pin. Cached pages return to the free
        list immediately; live ones simply lose their parking spot."""
        for p in pages:
            self._registered.discard(p)
            if p in self._cached:
                self._cached.remove(p)
                self._free_pages.append(p)

    # -- device page ops -------------------------------------------------

    def _pages(self, pages: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(pages, dtype=torch.int64).to(self.device)

    def _device_copy_pages(self, src: List[int], dst: List[int]) -> None:
        """Arena-level page copy (all layers), in place: one
        ``index_copy_`` a leaf, no arena reallocation."""
        s, d = self._pages(src), self._pages(dst)
        for key in _PAGE_KEYS:
            if key in self.cache:
                leaf = self.cache[key]
                leaf.index_copy_(1, d, leaf.index_select(1, s))

    def cow(self, lane: int, logical_idx: int) -> int:
        """Copy-on-write: give ``lane`` a private copy of the page at
        ``logical_idx`` (device page copy + remap). The original keeps its
        other references / cached registration. Returns the new page."""
        assert lane in self._pages_of
        src = self._pages_of[lane][logical_idx]
        assert len(self._free_pages) >= 1, "cow with empty free list"
        [dst] = self._take_free(1)
        self._device_copy_pages([src], [dst])
        self._pages_of[lane][logical_idx] = dst
        self.page_table[lane, logical_idx] = dst
        self._unref(src)
        return dst

    def spill(self, lane: int) -> PageSpill:
        """Device→host byte image of the lane (pages in logical order, CPU
        tensors of the arena's dtype). Caller releases the lane afterwards;
        restore() reproduces the exact bytes in freshly-allocated pages."""
        assert lane in self._pages_of
        pages = self._pages_of[lane]
        idx = self._pages(pages)
        out_pages: Dict[str, torch.Tensor] = {}
        out_rows: Dict[str, torch.Tensor] = {}
        for key, leaf in self.cache.items():
            if key in _PAGE_KEYS:
                out_pages[key] = leaf.index_select(1, idx).cpu()
            else:
                # A copy on every device: on the CPU, .cpu() would return a
                # view that the lane's next occupant overwrites.
                out_rows[key] = leaf[:, lane].to("cpu", copy=True)
        return PageSpill(n_pages=len(pages), pages=out_pages,
                         lane_rows=out_rows)

    def restore(self, image: PageSpill) -> Optional[Tuple[int, List[int]]]:
        """Allocate a fresh lane + pages and scatter the spilled bytes
        back, byte-identical, in place. None when the pool can't admit it
        now."""
        got = self.alloc(image.n_pages)
        if got is None:
            return None
        lane, pages = got
        idx = self._pages(pages)
        for key, host in image.pages.items():
            leaf = self.cache[key]
            leaf.index_copy_(1, idx, host.to(device=self.device, dtype=leaf.dtype))
        for key, host in image.lane_rows.items():
            self.cache[key][:, lane] = host.to(self.device)
        return lane, pages

    def check_invariants(self) -> None:
        """Free/live/cached pages partition range(n_pages); refcounts
        count mapping lanes exactly; cached ⇔ (rc == 0 ∧ registered);
        page tables mirror the allocator; same for lanes."""
        free = set(self._free_pages)
        assert len(free) == len(self._free_pages), "dup page in free list"
        live = {p for p, rc in self._refcount.items() if rc > 0}
        assert set(self._refcount) == live, "zero refcount retained"
        assert not (free & live), "free page has a refcount"
        assert not (free & self._cached), "cached page in free list"
        assert not (live & self._cached), "cached page is live"
        assert free | live | self._cached == set(range(self.n_pages))
        assert self._cached <= self._registered, "cached but unregistered"
        counts: Dict[int, int] = {}
        for lane, pages in self._pages_of.items():
            ps = set(pages)
            assert len(ps) == len(pages), f"lane {lane} maps a page twice"
            for p in pages:
                counts[p] = counts.get(p, 0) + 1
            row = self.page_table[lane]
            assert list(row[:len(pages)]) == pages, "page table out of sync"
            assert (row[len(pages):] == self.sink).all()
        assert counts == self._refcount, (
            f"refcounts {self._refcount} != mapping counts {counts}")
        free_lanes = set(self._free_lanes)
        assert len(free_lanes) == len(self._free_lanes), "dup free lane"
        assert free_lanes | set(self._pages_of) == set(range(self.n_lanes))
        assert not (free_lanes & set(self._pages_of))
        for lane in free_lanes:
            assert (self.page_table[lane] == self.sink).all(), (
                f"free lane {lane} still holds page mappings")

    # -- device cache ----------------------------------------------------

    def swap_cache(self, new_cache: Any) -> Any:
        """Install the cache dict a step returns. The port's steps update
        the arena in place and return the same tensors, so this keeps the
        reference's interface and swaps nothing new in."""
        old, self.cache = self.cache, new_cache
        return old
