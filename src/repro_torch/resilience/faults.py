"""Deterministic fault injection, a copy of the JAX package's
``repro.resilience.faults`` (DESIGN.md §13).

A *fault plan* is a finite schedule mapping ``(site, nth)`` — a named
injection site and the 0-based index of a call to it — to an action:

    raise    raise :class:`InjectedFault` at the call site
    hang     sleep ``seconds`` (models a stuck worker; watchdogs must
             recover without waiting for it)
    delay    sleep ``seconds`` and continue (models stragglers / slow IO)
    corrupt  transform the payload passed to :func:`inject` (NaN-poison
             float arrays or tensors; models bad batches / flipped bits)

Sites are plain strings (``"train/batch"``, ``"checkpoint/write"``, ...);
the registry of wired sites lives in DESIGN.md §13. Call sites are
one-liners::

    faults.fire("serve/prefill")           # may raise / sleep
    batch = faults.inject("train/batch", batch)   # may also corrupt

Determinism: a plan fires as a pure function of the per-site invocation
counter, never of wall time or thread identity, so a replayed run sees
exactly the same faults at exactly the same calls — and a *re*-run of a
recovered region (rollback-replay) sees fresh invocation indices, i.e.
the fault does not re-fire. That is what makes "recoverable schedule ⇒
bit-equal to fault-free" a testable invariant rather than a hope.

Cost when disabled: module-level ``_ACTIVE`` is ``None`` and both entry
points return after a single attribute check — the same
null-singleton discipline as ``obs.NULL_REGISTRY``, safe to leave in
hot paths permanently.

Scoping: ``with faults.install(plan) as reg:`` activates a plan for the
dynamic extent (threads started inside see it too — the registry is
process-global, counters lock-protected). Subprocesses inherit plans via
the ``REPRO_FAULT_PLAN`` environment variable (JSON, read at import), the
same variable the JAX package reads, so one plan drives either package
from outside the process.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_ACTIONS = ("raise", "hang", "delay", "corrupt")
_ENV_VAR = "REPRO_FAULT_PLAN"


class InjectedFault(RuntimeError):
    """Raised by a ``raise``-action fault. Carries (site, nth) so handlers
    and test assertions can tell injected failures from organic ones."""

    def __init__(self, site: str, nth: int):
        super().__init__(f"injected fault at {site}[{nth}]")
        self.site = site
        self.nth = nth


@dataclass(frozen=True)
class Fault:
    """One scheduled action: fire at the ``nth`` call to ``site``."""
    site: str
    nth: int
    action: str          # one of _ACTIONS
    seconds: float = 0.0  # hang / delay duration

    def __post_init__(self):
        assert self.action in _ACTIONS, self.action
        assert self.nth >= 0, self.nth


class FaultPlan:
    """Immutable schedule of :class:`Fault`s, keyed by (site, nth).

    Duplicate keys keep the first entry (hypothesis-generated schedules
    need not dedupe). JSON round-trip via :meth:`to_json` /
    :meth:`from_json` supports the env-var subprocess install.
    """

    def __init__(self, faults: Sequence[Fault] = ()):
        by_key: Dict[Tuple[str, int], Fault] = {}
        for f in faults:
            by_key.setdefault((f.site, f.nth), f)
        self._by_key = by_key

    @property
    def faults(self) -> Tuple[Fault, ...]:
        return tuple(self._by_key.values())

    def get(self, site: str, nth: int) -> Optional[Fault]:
        return self._by_key.get((site, nth))

    def sites(self) -> Tuple[str, ...]:
        return tuple(sorted({s for s, _ in self._by_key}))

    def to_json(self) -> str:
        return json.dumps([{"site": f.site, "nth": f.nth,
                            "action": f.action, "seconds": f.seconds}
                           for f in self.faults])

    @classmethod
    def from_json(cls, spec: str) -> "FaultPlan":
        return cls([Fault(**d) for d in json.loads(spec)])


class FaultRegistry:
    """Live counters + fired-fault log for one installed plan."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._counts: Dict[str, int] = {}
        self.fired: List[Fault] = []
        self._lock = threading.Lock()

    def next_fault(self, site: str) -> Optional[Fault]:
        """Advance ``site``'s invocation counter; return the scheduled
        fault for this call, if any."""
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            f = self.plan.get(site, n)
            if f is not None:
                self.fired.append(f)
            return f

    def count(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)


# Process-global active registry. None ⇒ injection disabled (the fast
# path: one load + one compare per call site).
_ACTIVE: Optional[FaultRegistry] = None


def active() -> Optional[FaultRegistry]:
    return _ACTIVE


@contextmanager
def install(plan: FaultPlan):
    """Activate ``plan`` for the dynamic extent; restores the previous
    registry (usually None) on exit. Yields the :class:`FaultRegistry`."""
    global _ACTIVE
    reg = FaultRegistry(plan)
    prev = _ACTIVE
    _ACTIVE = reg
    try:
        yield reg
    finally:
        _ACTIVE = prev


def _act(f: Fault) -> None:
    if f.action == "raise":
        raise InjectedFault(f.site, f.nth)
    if f.action in ("hang", "delay"):
        time.sleep(f.seconds if f.seconds > 0 else 60.0
                   if f.action == "hang" else 0.0)
    # "corrupt" at a payload-free site is a no-op: nothing to transform.


def fire(site: str) -> None:
    """Hit ``site``. May raise :class:`InjectedFault` or sleep."""
    reg = _ACTIVE
    if reg is None:
        return
    f = reg.next_fault(site)
    if f is not None:
        _act(f)


def inject(site: str, value: Any) -> Any:
    """Hit ``site`` with a payload. ``corrupt`` actions return a
    NaN-poisoned copy of ``value``; other actions behave like
    :func:`fire` and return ``value`` unchanged."""
    reg = _ACTIVE
    if reg is None:
        return value
    f = reg.next_fault(site)
    if f is None:
        return value
    if f.action == "corrupt":
        return poison(value)
    _act(f)
    return value


def _poisoned(v: Any) -> Optional[Any]:
    """A NaN-poisoned copy of a float array or tensor, else None."""
    if isinstance(v, torch.Tensor):
        if not v.is_floating_point():
            return None
        bad = v.clone(memory_format=torch.contiguous_format)
        bad.view(-1)[0] = float("nan")
        return bad
    a = np.asarray(v)
    if not np.issubdtype(a.dtype, np.floating):
        return None
    bad = np.array(a, copy=True)
    bad.reshape(-1)[0] = np.nan
    return bad


def poison(value: Any) -> Any:
    """NaN-poison the first float array or tensor reachable in ``value``
    (a dict, an array or a tensor), copying: the caller's original is never
    mutated."""
    if isinstance(value, dict):
        out = dict(value)
        for k, v in value.items():
            bad = _poisoned(v)
            if bad is not None:
                out[k] = bad
                return out
        return out
    bad = _poisoned(value)
    return value if bad is None else bad


def random_plan(seed: int, sites: Sequence[str], n_faults: int,
                actions: Sequence[str] = ("raise", "delay", "corrupt"),
                max_nth: int = 8, seconds: float = 0.005) -> FaultPlan:
    """Seeded random schedule over ``sites`` — the chaos suite's generator
    when hypothesis isn't driving."""
    rng = np.random.default_rng(seed)
    faults = [Fault(site=str(rng.choice(list(sites))),
                    nth=int(rng.integers(0, max_nth)),
                    action=str(rng.choice(list(actions))),
                    seconds=seconds)
              for _ in range(n_faults)]
    return FaultPlan(faults)


def _install_from_env() -> None:
    spec = os.environ.get(_ENV_VAR)
    if spec:
        global _ACTIVE
        _ACTIVE = FaultRegistry(FaultPlan.from_json(spec))


_install_from_env()
