"""Host-side phase tracing, the port of the JAX package's
``repro.obs.trace`` (DESIGN.md §10).

:func:`span` times a named phase with ``time.perf_counter`` and records the
duration into a registry histogram of the same name (``train/phase/step``,
``serve/phase/decode``, ``genfit/phase/fit``, …). Spans nest: a
thread-local stack tracks the open spans, so instrumented code can ask
:func:`current_spans` where it is (and the stack is restored even when the
body raises).

Device alignment: with ``registry.annotate`` set, every span also opens a
``torch.profiler.record_function`` range, so the host phase boundaries
appear as named ranges in a ``torch.profiler`` trace and device work can be
attributed to the host phase that launched it. :class:`ProfileWindow`
drives such a capture for a bounded step window: profiling a 100k-step run
must not write 100k steps of trace.

Disabled fast path: when the registry is off (or None), ``span()`` returns
a shared no-op context manager: no Span object, no clock read, nothing on
the stack.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional, Tuple

import torch

from repro_torch.obs.registry import Registry

_tls = threading.local()


def _stack():
    s = getattr(_tls, "spans", None)
    if s is None:
        s = _tls.spans = []
    return s


def current_spans() -> Tuple[str, ...]:
    """Names of the open spans on this thread, outermost first."""
    return tuple(_stack())


class Span:
    """Timed phase: records seconds into ``registry.histogram(name)``."""

    __slots__ = ("name", "_hist", "_annotation", "t0", "seconds")

    def __init__(self, name: str, registry: Registry):
        self.name = name
        self._hist = registry.histogram(name)
        self._annotation = (torch.profiler.record_function(name)
                            if registry.annotate else None)
        self.t0 = 0.0
        self.seconds: Optional[float] = None

    def __enter__(self) -> "Span":
        _stack().append(self.name)
        if self._annotation is not None:
            self._annotation.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = time.perf_counter() - self.t0
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
        self._hist.observe(self.seconds)
        popped = _stack().pop()
        assert popped == self.name, f"span stack corrupt: {popped} != {self.name}"


class _NullSpan:
    __slots__ = ()
    name = "<null>"
    seconds = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


def span(name: str, registry: Optional[Registry] = None):
    """Context manager timing ``name`` into ``registry``. With a None or
    disabled registry this returns a shared no-op singleton (zero
    allocation: a loop can wrap every step unconditionally)."""
    if registry is None or not registry.enabled:
        return _NULL_SPAN
    return Span(name, registry)


class ProfileWindow:
    """Bounded ``torch.profiler`` capture driven by a step loop.

    ``tick(step)`` starts a host (and, with a card, device) trace the first
    time it is called (call it from steady-state steps only, so warm-up
    never pollutes the capture) and stops it after ``n_steps`` ticks,
    writing the Chrome trace to ``<profile_dir>/trace.json``. Inert when
    ``profile_dir`` is falsy; ``stop()`` is idempotent and always safe to
    call at loop exit.
    """

    def __init__(self, profile_dir: Optional[str], n_steps: int = 5):
        self.profile_dir = profile_dir
        self.n_steps = n_steps
        self._ticks = 0
        self._prof = None

    def tick(self, step: int) -> None:
        if not self.profile_dir:
            return
        if self._prof is None and self._ticks == 0:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()
        self._ticks += 1
        if self._ticks >= self.n_steps:
            self.stop()

    @property
    def trace_path(self) -> Optional[str]:
        return (os.path.join(self.profile_dir, "trace.json")
                if self.profile_dir else None)

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None               # one window per run: _ticks stays > 0
