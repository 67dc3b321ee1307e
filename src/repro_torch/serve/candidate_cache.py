"""Prefix-keyed LRU cache of beam-proposed candidate sets.

The expensive part of the sublinear decode is the tree descent:
``tree_lib.beam_search`` walks the adversarial generator for O(beam·k·log C)
per token. But greedy decode is deterministic — the candidate set the tree
proposes depends only on the token *prefix* (prompt + tokens generated so
far), because the hidden state, hence the generator feature
``x_gen = proj(h)``, is a pure function of that prefix under fixed params.
Repeated prefixes (shared system prompts, retried requests, common query
heads — the ROADMAP's named workload) can therefore skip the descent
entirely and jump straight to candidate re-scoring
(``candidate_scores`` / ``gather_scores`` + Eq. 5 debias), which is
O(beam·K) with no tree in sight.

Key scheme: ``key = tuple(prompt tokens) + tuple(generated tokens)`` — the
full history whose last token is the decode step's input. Value: the
``(candidates, log_pn)`` pair beam search returned for that step, as host
numpy arrays of shape (beam,). Exactness: on a true prefix repeat the
hidden state is bit-identical, so scoring cached candidates reproduces the
fresh path byte-for-byte; the cache can never change outputs, only skip
work — PROVIDED the generator that proposed the entry is still installed.
A generator swap changes the tree, hence the candidate sets and the Eq. 5
``log_pn`` debias terms, so every pre-swap entry is stale the moment a new
head state lands: entries are keyed on an explicit generator ``version``
and :meth:`CandidateCache.bump_version` (called by
``Engine.swap_head_state``) retires the whole resident set at once.
Eviction is plain LRU. Sizing: the value arrays are tiny
(beam · 8 bytes) but the tuple key costs ~8 bytes per history token plus
Python object overhead — roughly 2 KB for a 256-token prefix — so size
the capacity against key memory (a hashed/rolling key is the upgrade path
if million-entry caches over long prefixes are ever needed).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

Key = Tuple[int, ...]


class CandidateCache:
    """LRU map: token-prefix → (candidates (beam,), log_pn (beam,))."""

    def __init__(self, capacity: int = 4096):
        assert capacity >= 1
        self.capacity = capacity
        self._data: "OrderedDict[tuple, Tuple[np.ndarray, np.ndarray]]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Generator version the resident entries were proposed under.
        # Bumped (and the map cleared) on every head-state swap — a cached
        # (candidates, log_pn) pair is only exact for the tree that
        # produced it.
        self.version = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: Key) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        hit = self._data.get((self.version, *key))
        if hit is None:
            self.misses += 1
            return None
        self._data.move_to_end((self.version, *key))
        self.hits += 1
        return hit

    def put(self, key: Key, candidates: np.ndarray,
            log_pn: np.ndarray) -> None:
        key = (self.version, *key)
        if key in self._data:
            self._data.move_to_end(key)
            return
        self._data[key] = (np.asarray(candidates), np.asarray(log_pn))
        if len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.evictions += 1

    def bump_version(self) -> None:
        """Invalidate every resident entry (generator swap). The version
        prefix in the key makes this airtight even if a clear were ever
        made lazy: post-swap lookups can only match post-swap entries."""
        self._data.clear()
        self.version += 1
        self.invalidations += 1

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "size": len(self._data),
                "hit_rate": self.hit_rate, "version": self.version,
                "invalidations": self.invalidations}
