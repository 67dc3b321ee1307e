"""Dependency-free metrics registry, a copy of the JAX package's
``repro.obs.registry`` (DESIGN.md §10).

One process-local :class:`Registry` holds named instruments:

* :class:`Counter` — monotone event counts (``genfit/swaps``);
* :class:`Gauge` — last-written value (``snr/ewma``);
* :class:`Ewma` — exponentially-weighted series (host-side smoothing for
  quantities that are not already EWMA'd on device);
* :class:`Histogram` — fixed-bucket distribution with interpolated
  p50/p95/p99 (``serve/ttft_s``). Buckets are fixed at construction so
  ``observe`` is O(log n_buckets) with zero allocation — the property
  that lets the train loop observe every step.

Disabled mode is the hot-path contract: a ``Registry(enabled=False)``
hands out shared null singletons from module scope — ``counter()`` /
``gauge()`` / ``histogram()`` / ``ewma()`` allocate nothing, store
nothing, and their mutators are empty method calls. Call sites therefore
instrument unconditionally against ``registry or NULL_REGISTRY`` instead
of branching per metric (tests/test_torch_obs.py pins the
zero-allocation fast path with tracemalloc).

Metric names are ``/``-separated (``train/step_time_s``); the namespace
conventions (``train/*``, ``serve/*``, ``genfit/*``, ``snr/*``) are
documented in DESIGN.md §10 and asserted by the integration tests.
"""
from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence


class Counter:
    """Monotone counter. ``inc`` accepts negative deltas nowhere — a
    decreasing 'counter' is a gauge."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        assert n >= 0, f"counter {self.name} cannot decrease (inc {n})"
        self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value (None until first ``set``)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Ewma:
    """Exponentially-weighted moving average; first update seeds it."""

    __slots__ = ("name", "alpha", "value", "count")

    def __init__(self, name: str, alpha: float = 0.1):
        self.name = name
        self.alpha = alpha
        self.value: Optional[float] = None
        self.count = 0

    def update(self, v: float) -> None:
        v = float(v)
        self.value = (v if self.value is None
                      else (1.0 - self.alpha) * self.value + self.alpha * v)
        self.count += 1

    def snapshot(self) -> dict:
        return {"type": "ewma", "value": self.value, "alpha": self.alpha,
                "count": self.count}


def exp_buckets(lo: float, hi: float, per_decade: int = 20) -> List[float]:
    """Geometric bucket upper bounds covering [lo, hi]; quantile estimates
    carry at most one bucket ratio (10^(1/per_decade)) of relative error."""
    assert 0 < lo < hi
    n = int(math.ceil(per_decade * math.log10(hi / lo)))
    return [lo * 10.0 ** (i / per_decade) for i in range(n + 1)]


def linear_buckets(lo: float, hi: float, n: int) -> List[float]:
    """``n`` equal-width bucket upper bounds over [lo, hi]."""
    assert hi > lo and n >= 1
    w = (hi - lo) / n
    return [lo + w * (i + 1) for i in range(n)]


# Seconds, 1us .. ~17min: the default for every *_s latency histogram.
DEFAULT_TIME_BUCKETS = exp_buckets(1e-6, 1e3, per_decade=20)


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles.

    ``bounds`` are ascending bucket *upper* bounds; values above the last
    bound land in an implicit +inf overflow bucket. Exact count/sum/min/
    max ride along, so ``mean`` is exact and quantile estimates are
    clamped to the observed range (a single-value histogram reports that
    value for every quantile regardless of bucket width).
    """

    __slots__ = ("name", "bounds", "counts", "count", "total",
                 "vmin", "vmax")

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds = list(bounds if bounds is not None
                           else DEFAULT_TIME_BUCKETS)
        assert self.bounds == sorted(self.bounds), "bounds must ascend"
        self.counts = [0] * (len(self.bounds) + 1)   # +1: overflow
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def quantile(self, q: float) -> Optional[float]:
        """Linear interpolation inside the bucket holding rank ``q`` —
        the bucketed analogue of ``numpy.quantile(..., 'linear')``."""
        assert 0.0 <= q <= 1.0
        if not self.count:
            return None
        target = q * (self.count - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c > target:
                lo = self.bounds[i - 1] if i > 0 else self.vmin
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                lo, hi = max(lo, self.vmin), min(hi, self.vmax)
                if c == 1 or hi <= lo:
                    return max(lo, min(hi, lo))
                # Ranks cum..cum+c-1 spread linearly over [lo, hi]
                # (numpy's 'linear' method restricted to the bucket).
                frac = (target - cum) / (c - 1)
                return lo + (hi - lo) * min(frac, 1.0)
            cum += c
        return self.vmax

    def snapshot(self) -> dict:
        empty = not self.count
        return {"type": "histogram", "count": self.count,
                "sum": self.total, "mean": self.mean,
                "min": None if empty else self.vmin,
                "max": None if empty else self.vmax,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class _NullCounter:
    __slots__ = ()
    name = "<null>"
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def snapshot(self) -> dict:
        return {"type": "counter", "value": 0}


class _NullGauge:
    __slots__ = ()
    name = "<null>"
    value = None

    def set(self, v: float) -> None:
        pass

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": None}


class _NullEwma:
    __slots__ = ()
    name = "<null>"
    value = None
    count = 0

    def update(self, v: float) -> None:
        pass

    def snapshot(self) -> dict:
        return {"type": "ewma", "value": None, "alpha": 0.0, "count": 0}


class _NullHistogram:
    __slots__ = ()
    name = "<null>"
    count = 0
    mean = None

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> Optional[float]:
        return None

    def snapshot(self) -> dict:
        return {"type": "histogram", "count": 0, "sum": 0.0, "mean": None,
                "min": None, "max": None, "p50": None, "p95": None,
                "p99": None}


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_EWMA = _NullEwma()
NULL_HISTOGRAM = _NullHistogram()


class Registry:
    """Named-instrument store. ``get_or_create`` semantics: the first
    call fixes the instrument's type (and a histogram's buckets); later
    calls with the same name return the same object, and a type mismatch
    is a bug (asserted), not a silent second metric.

    ``annotate=True`` makes :func:`repro_torch.obs.trace.span`
    additionally open a ``torch.profiler.record_function`` range per span,
    so device profiles line up with the host phase timings.
    """

    def __init__(self, enabled: bool = True, annotate: bool = False):
        self.enabled = enabled
        self.annotate = annotate
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args, **kwargs)
            self._metrics[name] = m
        assert isinstance(m, cls), (
            f"metric {name!r} already registered as "
            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return NULL_COUNTER
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return NULL_GAUGE
        return self._get(name, Gauge)

    def ewma(self, name: str, alpha: float = 0.1) -> Ewma:
        if not self.enabled:
            return NULL_EWMA
        return self._get(name, Ewma, alpha)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        if not self.enabled:
            return NULL_HISTOGRAM
        return self._get(name, Histogram, bounds)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """JSON-serializable view of every instrument (the ``summary``
        JSONL event and ``Engine.stats()['metrics']`` payload)."""
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}


# The shared disabled registry: call sites write
# ``reg = registry or NULL_REGISTRY`` once and then instrument
# unconditionally — no per-metric None checks on the hot path.
NULL_REGISTRY = Registry(enabled=False)
