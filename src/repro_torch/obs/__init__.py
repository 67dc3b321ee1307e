"""repro_torch.obs: metrics, tracing and profiling, the port of the JAX
package's ``repro.obs`` (DESIGN.md §10).

The one substrate a subsystem reports through: it writes to a
:class:`Registry` (counters / gauges / EWMAs / fixed-bucket histograms),
times its phases with :func:`span` (a ``torch.profiler.record_function``
range when the registry annotates), and exports through the JSONL event
log, the Prometheus text dump, or the console summary. Plain Python: no
module here touches the card.
"""
from repro_torch.obs.export import (EVENT_SCHEMA, JsonlExporter, MetricsServer,
                                    console_summary, prometheus_text, read_jsonl,
                                    start_metrics_server, validate_events)
from repro_torch.obs.registry import (DEFAULT_TIME_BUCKETS, NULL_COUNTER,
                                      NULL_EWMA, NULL_GAUGE, NULL_HISTOGRAM,
                                      NULL_REGISTRY, Counter, Ewma, Gauge,
                                      Histogram, Registry, exp_buckets,
                                      linear_buckets)
from repro_torch.obs.trace import ProfileWindow, Span, current_spans, span

__all__ = [
    "Counter", "Ewma", "Gauge", "Histogram", "Registry", "NULL_REGISTRY",
    "NULL_COUNTER", "NULL_GAUGE", "NULL_EWMA", "NULL_HISTOGRAM",
    "DEFAULT_TIME_BUCKETS", "exp_buckets", "linear_buckets",
    "Span", "span", "current_spans", "ProfileWindow",
    "JsonlExporter", "read_jsonl", "validate_events", "EVENT_SCHEMA",
    "prometheus_text", "console_summary", "MetricsServer",
    "start_metrics_server",
]
