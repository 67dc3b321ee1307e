"""Draft sources for speculative decode (DESIGN.md §12).

Speculative decode needs a cheap proposal chain ``d1..dk``; correctness
never depends on it (the verify step accepts exactly the longest prefix
the target model would have produced lock-step, so a bad draft costs only
wasted FLOPs). The drafts here come from the *fitted generator tree*
itself, in two forms:

- **Replay** (`ContinuationStore`): every token the engine emits is the
  tree's own greedy choice at some context; the store records
  ``context → next token`` and a draft is the stored chain walked k deep.
  On shared-prefix / repeat traffic (the adversarial benchmark shape)
  whole continuations replay and the mean accepted length approaches k.
- **Stale-feature seed**: the verify step scores EVERY draft position in
  one batched forward, so the tree's prediction one past the accepted
  prefix (the "bonus" token) is free — the engine feeds those selections
  back through `observe`, which is exactly the tree acting as its own
  draft model at one-step-stale features.

Entries are keyed by head-state *version* (bumped on `swap_head_state`)
so a hot-swapped classifier can never replay a stale tree's outputs, and
the store is a bounded LRU — eviction only ever costs future draft hits.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Protocol, Tuple

Ctx = Tuple[int, ...]

# Drafting conditions on at most this many trailing tokens: contexts this
# deep identify the continuation in practice, and bounded keys keep the
# store O(capacity) memory regardless of prompt length.
CTX_WINDOW = 48


class DraftSource(Protocol):
    """Proposal interface the engine drives. ``propose`` may return fewer
    than ``k`` tokens (including none); ``observe`` feeds back every token
    the engine actually emitted so the source can learn continuations."""

    def propose(self, ctx: Ctx, k: int) -> List[int]: ...

    def observe(self, ctx: Ctx, token: int) -> None: ...

    def bump_version(self) -> None: ...


class ContinuationStore:
    """Version-keyed LRU of ``trailing-context → next token``."""

    def __init__(self, capacity: int = 8192):
        assert capacity >= 1
        self.capacity = capacity
        self.version = 0
        self._map: "OrderedDict[Tuple[int, Ctx], int]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key_ctx(ctx: Ctx) -> Ctx:
        return ctx[-CTX_WINDOW:]

    def put(self, ctx: Ctx, token: int) -> None:
        key = (self.version, self._key_ctx(ctx))
        self._map[key] = int(token)
        self._map.move_to_end(key)
        while len(self._map) > self.capacity:
            self._map.popitem(last=False)

    def get(self, ctx: Ctx) -> Optional[int]:
        key = (self.version, self._key_ctx(ctx))
        tok = self._map.get(key)
        if tok is None:
            self.misses += 1
            return None
        self._map.move_to_end(key)
        self.hits += 1
        return tok

    def chain(self, ctx: Ctx, k: int) -> List[int]:
        """Walk stored continuations up to ``k`` tokens deep."""
        out: List[int] = []
        cur = ctx
        for _ in range(k):
            tok = self.get(cur)
            if tok is None:
                break
            out.append(tok)
            cur = cur + (tok,)
        return out

    def bump_version(self) -> None:
        """Invalidate everything recorded under the old head state.
        Entries age out of the LRU rather than being swept eagerly."""
        self.version += 1


class ReplayDraft:
    """`DraftSource` over a `ContinuationStore`: proposes the recorded
    continuation chain of the current context."""

    def __init__(self, capacity: int = 8192):
        self.store = ContinuationStore(capacity)

    def propose(self, ctx: Ctx, k: int) -> List[int]:
        return self.store.chain(ctx, k)

    def observe(self, ctx: Ctx, token: int) -> None:
        self.store.put(ctx, token)

    def bump_version(self) -> None:
        self.store.bump_version()


class NullDraft:
    """Always-empty proposals: speculative plumbing with lock-step
    behavior (every verify step advances exactly one token)."""

    def propose(self, ctx: Ctx, k: int) -> List[int]:
        return []

    def observe(self, ctx: Ctx, token: int) -> None:
        pass

    def bump_version(self) -> None:
        pass
