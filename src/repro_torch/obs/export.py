"""Exporters, a copy of the JAX package's ``repro.obs.export``
(DESIGN.md §10): JSONL event log, Prometheus text dump, console summary.

The JSONL log is the run's machine-readable record: one JSON object per
line, every object carrying an ``event`` type and the emitting ``step``
(serving events carry ``engine_step``). The schema is deliberately
small and append-only — downstream tooling (benchmarks, dashboards,
tests/test_torch_obs.py) validates with :func:`validate_events`, so adding a
field is free and renaming one is a breaking change that fails CI
(``make obs-demo``).

Event types and required fields (``EVENT_SCHEMA``):

* ``step``       — per-train-step sample at ``metrics_interval``:
                   ``step``, ``loss``, ``step_time_s`` (+ ``snr_proxy``
                   / ``snr_ewma`` / ``snr_ref`` when the head emits them).
* ``compile``    — the first executed step of a process, whose wall time
                   is XLA compilation, kept OUT of step-time stats.
* ``gen_submit`` / ``gen_swap`` / ``snr_trigger`` — generator refresh
                   lifecycle (``gen_swap`` carries ``old_fit_step``,
                   ``new_fit_step``, ``fit_wall_s``,
                   ``steps_stale_at_swap``).
* ``request``    — one served request: queue wait, TTFT, total latency.
                   Requests terminated by the resilience paths (deadline
                   abort / poison isolation) carry ``status`` and null
                   out whichever of the latency triple never happened.
* ``serve_step`` — engine-iteration sample: queue depth, active lanes,
                   page occupancy.
* ``nonfinite_skip`` / ``rollback_restore`` — train-loop degradation
                   ladder (DESIGN.md §13): a skipped non-finite step;
                   a rollback-restore to ``restored_step``.
* ``gen_refresh_failed`` — a generator fit that exhausted its retries or
                   hung past the watchdog; the loop kept the stale
                   generator and re-armed the SNR trigger.
* ``summary``    — final registry snapshot (one per run, last line).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.registry import Registry

EVENT_SCHEMA: Dict[str, tuple] = {
    "step": ("step", "loss", "step_time_s"),
    "compile": ("step", "compile_time_s"),
    "gen_submit": ("step",),
    "gen_swap": ("step", "old_fit_step", "new_fit_step", "fit_wall_s",
                 "steps_stale_at_swap"),
    "gen_refresh_failed": ("step", "submit_step", "reason"),
    "snr_trigger": ("step",),
    "nonfinite_skip": ("step", "streak"),
    "rollback_restore": ("step", "restored_step"),
    "request": ("request_id", "tokens", "admission_wait_s", "ttft_s",
                "latency_s"),
    "serve_step": ("engine_step", "queue_depth", "active",
                   "page_occupancy"),
    "summary": ("metrics",),
}


class JsonlExporter:
    """Line-per-event JSON writer. Each ``emit`` writes and flushes one
    line (events are rare relative to device work, and a crashed run
    must leave a readable log). Usable as a context manager; ``emit`` on
    a closed or path-less exporter is a silent no-op so shutdown races
    (background genfit swap vs loop exit) cannot throw."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = open(path, "w") if path else None
        self.n_events = 0

    def emit(self, event: dict) -> None:
        if self._f is None:
            return
        assert "event" in event, f"event missing 'event' type: {event}"
        self._f.write(json.dumps(event, sort_keys=True) + "\n")
        self._f.flush()
        self.n_events += 1

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "JsonlExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def validate_events(events: List[dict]) -> None:
    """Assert the JSONL schema: every event typed, required fields
    present, numeric fields numeric. Unknown event types are an error —
    the schema table IS the compatibility contract."""
    assert events, "empty event log"
    for i, ev in enumerate(events):
        assert isinstance(ev, dict) and "event" in ev, f"line {i}: {ev}"
        kind = ev["event"]
        assert kind in EVENT_SCHEMA, f"line {i}: unknown event {kind!r}"
        missing = [k for k in EVENT_SCHEMA[kind] if k not in ev]
        assert not missing, f"line {i} ({kind}): missing {missing}"
        for k, v in ev.items():
            if k.endswith(("_s", "_time")) or k in ("loss", "step"):
                assert v is None or isinstance(v, (int, float)), \
                    f"line {i} ({kind}): {k}={v!r} not numeric"


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return ("_" + s) if s[:1].isdigit() else s


def prometheus_text(registry: Registry) -> str:
    """Prometheus text exposition of the registry. Histograms export
    ``_count`` / ``_sum`` plus quantile samples (summary-style), which
    keeps the dump dependency-free and human-diffable."""
    lines = []
    for name, snap in registry.snapshot().items():
        pname = _prom_name(name)
        kind = snap["type"]
        if kind == "counter":
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {snap['value']}")
        elif kind in ("gauge", "ewma"):
            lines.append(f"# TYPE {pname} gauge")
            v = snap["value"]
            lines.append(f"{pname} {'NaN' if v is None else v}")
        else:   # histogram -> summary exposition
            lines.append(f"# TYPE {pname} summary")
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                v = snap[key]
                lines.append(f'{pname}{{quantile="{q}"}} '
                             f"{'NaN' if v is None else v}")
            lines.append(f"{pname}_sum {snap['sum']}")
            lines.append(f"{pname}_count {snap['count']}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Pull-based metrics endpoint: a stdlib HTTP thread serving
    :func:`prometheus_text` of a live registry at ``/metrics`` (and
    ``/`` — scrapers and health checks both land somewhere useful).

    Zero dependencies: ``http.server.ThreadingHTTPServer`` on a daemon
    thread, so a serving process exposes its engine registry without an
    agent sidecar, and the thread never blocks interpreter exit. The
    registry snapshot runs in the scrape thread; instruments are plain
    Python counters, so a torn read costs at worst one stale sample,
    never a crash. It binds localhost unless ``host`` names another
    interface. ``port=0`` binds an ephemeral port (tests); the bound port is
    on ``.port``.

    With ``health_fn`` (a zero-arg callable returning a JSON-able dict,
    e.g. ``Engine.health``) the server also answers the standard probe
    pair: ``/healthz`` — 200 with the snapshot whenever the process can
    answer at all (liveness); ``/readyz`` — 200 iff the snapshot's
    ``ready`` field is truthy, 503 otherwise (readiness: model compiled
    and the queue below the shed threshold), so a load balancer stops
    routing to a saturated or still-compiling engine without killing it.
    Without ``health_fn`` both paths 404 as before.
    """

    def __init__(self, registry: Registry, port: int,
                 host: str = "127.0.0.1", health_fn=None):
        import http.server
        import threading

        reg = registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):              # noqa: N802 (stdlib API name)
                path = self.path.split("?")[0]
                if health_fn is not None and path in ("/healthz",
                                                      "/readyz"):
                    try:
                        snap = health_fn()
                    except Exception as e:
                        self._reply(500, json.dumps(
                            {"error": repr(e)}).encode(),
                            "application/json")
                        return
                    code = (200 if path == "/healthz"
                            or snap.get("ready") else 503)
                    self._reply(code, json.dumps(
                        snap, sort_keys=True).encode(),
                        "application/json")
                    return
                if path not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                self._reply(200, prometheus_text(reg).encode(),
                            "text/plain; version=0.0.4")

            def _reply(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log events
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-server", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(registry: Registry, port: int,
                         host: str = "127.0.0.1",
                         health_fn=None) -> MetricsServer:
    """Serve ``registry`` as Prometheus text on ``http://host:port/metrics``
    from a daemon thread. Returns the running server (``.port`` holds the
    bound port; ``.close()`` stops it). With ``health_fn`` the server also
    answers ``/healthz`` and ``/readyz`` (see :class:`MetricsServer`)."""
    return MetricsServer(registry, port, host, health_fn=health_fn)


def console_summary(registry: Registry, title: str = "metrics") -> str:
    """End-of-run table: one aligned line per instrument, histograms as
    count/mean/p50/p95/p99 (seconds metrics render in ms)."""

    def fmt(name, v):
        if v is None:
            return "-"
        if name.endswith("_s"):
            return f"{v * 1e3:.2f}ms"
        return f"{v:.4g}" if isinstance(v, float) else str(v)

    rows = []
    for name, snap in registry.snapshot().items():
        if snap["type"] == "counter":
            rows.append((name, f"{snap['value']}"))
        elif snap["type"] in ("gauge", "ewma"):
            rows.append((name, fmt(name, snap["value"])))
        else:
            rows.append((name, (f"n={snap['count']} "
                                f"mean={fmt(name, snap['mean'])} "
                                f"p50={fmt(name, snap['p50'])} "
                                f"p95={fmt(name, snap['p95'])} "
                                f"p99={fmt(name, snap['p99'])}")))
    if not rows:
        return f"== {title}: (empty) =="
    width = max(len(r[0]) for r in rows)
    body = "\n".join(f"  {n:<{width}}  {v}" for n, v in rows)
    return f"== {title} ==\n{body}"
