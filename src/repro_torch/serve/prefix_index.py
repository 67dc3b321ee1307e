"""Radix index over token histories → physical KV pages (DESIGN.md §12).

The trie is chunked at page granularity: each edge is a tuple of exactly
``page_len`` tokens, and the node it leads to names the ONE canonical
physical page whose KV encodes those tokens *in the context of the path
above it*. A page is shareable read-only because its KV depends only on
tokens up to its last position — every request whose prompt starts with
the same ``(depth+1) * page_len`` tokens computes bit-identical K/V for
that page, so they can all gather through it (refcounts in ``PagedPool``
keep it alive; nobody writes a full prompt page after prefill).

Partial *tail* pages (a prompt's last ``len % page_len`` tokens) can't be
shared read-only — the owner keeps writing its own decode KV into the
same physical page — so they are indexed separately per node, keyed by
the exact remaining-token tuple, and reused by **copy-on-write**: an
exact-prompt repeat device-copies the tail page into a private page and
skips its prefill; bytes at offsets past the tail are the donor's decode
KV, dead for the new request by causal masking until overwritten by its
own writes at those very positions.

Lifetime: nodes are registered with the pool (``pool.register``) so their
pages park as *cached* (bytes intact, evictable) when the last mapping
lane releases, instead of returning to the free list. Eviction is
LRU leaf-first — since any lane mapping a child page also maps its parent
(page tables list the whole prefix), rc(parent) ≥ rc(child), so an
evictable (rc == 0) interior node can only appear once its entire subtree
is evictable; draining leaves bottom-up never strands reachable pages.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

TokenChunk = Tuple[int, ...]


class _Node:
    __slots__ = ("chunk", "page", "parent", "children", "tails",
                 "tail_ticks", "tick")

    def __init__(self, chunk: Optional[TokenChunk], page: Optional[int],
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.page = page                  # None only at the root
        self.parent = parent
        self.children: Dict[TokenChunk, _Node] = {}
        self.tails: Dict[TokenChunk, int] = {}       # tail tokens -> page
        self.tail_ticks: Dict[TokenChunk, int] = {}
        self.tick = 0


class PrefixMatch:
    """Result of a longest-prefix lookup."""
    __slots__ = ("pages", "tokens_matched", "tail_page", "tail_len")

    def __init__(self, pages: List[int], tokens_matched: int,
                 tail_page: Optional[int], tail_len: int):
        self.pages = pages                # full shared pages, logical order
        self.tokens_matched = tokens_matched
        self.tail_page = tail_page        # COW donor for the exact tail
        self.tail_len = tail_len


class PrefixIndex:
    """Page-granular radix trie with LRU leaf-first eviction."""

    def __init__(self, page_len: int):
        assert page_len >= 1
        self.page_len = page_len
        self.root = _Node(None, None, None)
        self._clock = itertools.count(1)
        self.n_nodes = 0
        self.n_tails = 0

    # -- lookup ----------------------------------------------------------

    def match(self, tokens) -> PrefixMatch:
        """Longest registered prefix of ``tokens``: full-page path first,
        then (only when every full chunk matched) an exact-tail COW donor.
        Touches the LRU clock on everything it returns."""
        toks = [int(t) for t in tokens]
        pl = self.page_len
        n_full = len(toks) // pl
        node, pages = self.root, []
        tick = next(self._clock)
        for i in range(n_full):
            child = node.children.get(tuple(toks[i * pl:(i + 1) * pl]))
            if child is None:
                return PrefixMatch(pages, len(pages) * pl, None, 0)
            child.tick = tick
            pages.append(child.page)
            node = child
        tail = tuple(toks[n_full * pl:])
        tail_page = node.tails.get(tail) if tail else None
        if tail_page is not None:
            node.tail_ticks[tail] = tick
        return PrefixMatch(pages, len(pages) * pl, tail_page,
                           len(tail) if tail_page is not None else 0)

    # -- registration ----------------------------------------------------

    def insert(self, tokens, pages: List[int], pool) -> int:
        """Register a freshly-prefilled prompt: missing full-chunk nodes
        adopt the lane's pages (logical order), and a non-empty remainder
        becomes a tail entry. Existing nodes keep their canonical page —
        the lane's duplicate stays private. Returns #pages registered."""
        toks = [int(t) for t in tokens]
        pl = self.page_len
        n_full = len(toks) // pl
        assert len(pages) >= -(-len(toks) // pl), (len(pages), len(toks))
        node, registered = self.root, 0
        tick = next(self._clock)
        for i in range(n_full):
            chunk = tuple(toks[i * pl:(i + 1) * pl])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, pages[i], node)
                node.children[chunk] = child
                pool.register([pages[i]])
                self.n_nodes += 1
                registered += 1
            child.tick = tick
            node = child
        tail = tuple(toks[n_full * pl:])
        if tail and tail not in node.tails:
            node.tails[tail] = pages[n_full]
            node.tail_ticks[tail] = tick
            pool.register([pages[n_full]])
            self.n_tails += 1
            registered += 1
        return registered

    # -- eviction --------------------------------------------------------

    def _evictable(self, pool) -> List[Tuple[int, str, _Node, TokenChunk]]:
        """(tick, kind, node, key) for every LRU-eligible entry: tail
        entries whose page is cached, and childless+tailless nodes whose
        page is cached."""
        out = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            for tail, page in node.tails.items():
                if pool.is_cached(page):
                    out.append((node.tail_ticks[tail], "tail", node, tail))
            if (node is not self.root and not node.children
                    and not node.tails and pool.is_cached(node.page)):
                out.append((node.tick, "node", node, node.chunk))
        return out

    def evict_lru(self, pool) -> int:
        """Evict the least-recently-used evictable entry (tail first at
        tick ties — it frees the same page count without orphaning a
        subtree). Returns pages freed (0 or 1; 0 ⇒ nothing evictable)."""
        cands = self._evictable(pool)
        if not cands:
            return 0
        cands.sort(key=lambda c: (c[0], c[1] != "tail"))
        _, kind, node, key = cands[0]
        if kind == "tail":
            page = node.tails.pop(key)
            node.tail_ticks.pop(key)
            self.n_tails -= 1
        else:
            page = node.page
            node.parent.children.pop(key)
            self.n_nodes -= 1
        pool.unregister([page])
        return 1

    def evict_until(self, pool, n_free: int) -> int:
        """Evict LRU entries until ``pool.num_free_pages >= n_free`` or
        nothing evictable remains. Returns pages freed."""
        freed = 0
        while pool.num_free_pages < n_free:
            got = self.evict_lru(pool)
            if not got:
                break
            freed += got
        return freed

    def clear(self, pool) -> None:
        """Unregister every entry (engine shutdown / head swap flush)."""
        stack = list(self.root.children.values())
        pages = list(self.root.tails.values())
        while stack:
            node = stack.pop()
            pages.append(node.page)
            pages.extend(node.tails.values())
            stack.extend(node.children.values())
        pool.unregister(pages)
        self.root = _Node(None, None, None)
        self.n_nodes = 0
        self.n_tails = 0
