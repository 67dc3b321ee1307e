"""The port's observability layer and fault injection against the JAX
package's: ``repro_torch.obs`` (registry, spans, exporters) mirrors the unit
cases of tests/test_obs.py, ``repro_torch.resilience.faults`` the fault-plan
unit cases of tests/test_resilience.py. Where both packages produce the same
artifact (the Prometheus text of one registry, the JSON of a seeded random
plan, a JSONL log) the test holds the port's against the reference's
byte for byte. The port's own additions: spans as
``torch.profiler.record_function`` ranges, a ``ProfileWindow`` that writes
a Chrome trace, and NaN-poisoning of tensors.
"""
import gc
import json
import os
import subprocess
import sys
import time
import tracemalloc
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.resilience import faults as jfaults
from repro_torch.obs import (Counter, Gauge, Histogram, JsonlExporter, NULL_COUNTER,
                             NULL_EWMA, NULL_GAUGE, NULL_HISTOGRAM, NULL_REGISTRY,
                             ProfileWindow, Registry, console_summary, current_spans,
                             exp_buckets, linear_buckets, prometheus_text, read_jsonl,
                             span, start_metrics_server, validate_events)
from repro_torch.obs.trace import _NULL_SPAN
from repro_torch.resilience import faults
from repro_torch.resilience.faults import Fault, FaultPlan, InjectedFault

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


# ---------------------------------------------------------------------------
# Instruments (tests/test_obs.py)
# ---------------------------------------------------------------------------

def test_counter_gauge_ewma_basics():
    """Mirror of test_obs.py::test_counter_gauge_ewma_basics."""
    c = Counter("c")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(AssertionError):
        c.inc(-1)
    g = Gauge("g")
    assert g.value is None
    g.set(2)
    g.set(1.5)
    assert g.value == 1.5
    e = Registry().ewma("e", alpha=0.5)
    e.update(1.0)
    assert e.value == 1.0
    e.update(3.0)
    assert e.value == 2.0 and e.count == 2


def test_registry_get_or_create_and_type_guard():
    """Mirror of test_obs.py::test_registry_get_or_create_and_type_guard."""
    r = Registry()
    assert r.counter("x") is r.counter("x")
    h = r.histogram("h", bounds=[1.0, 2.0])
    assert r.histogram("h") is h
    with pytest.raises(AssertionError):
        r.gauge("x")
    assert r.names() == ["h", "x"]


def test_bucket_builders_match_jax():
    """Mirror of test_obs.py::test_bucket_builders; the bounds equal the
    reference's bit for bit."""
    b = exp_buckets(1e-3, 1.0, per_decade=10)
    assert b == sorted(b) and b[0] == pytest.approx(1e-3) and b[-1] >= 1.0
    assert all(b[i + 1] / b[i] == pytest.approx(10 ** 0.1) for i in range(len(b) - 1))
    assert linear_buckets(0.0, 1.0, 4) == [0.25, 0.5, 0.75, 1.0]
    assert b == jobs.exp_buckets(1e-3, 1.0, per_decade=10)
    assert Histogram("h").bounds == list(jobs.DEFAULT_TIME_BUCKETS)


def test_histogram_quantiles_vs_numpy_and_jax():
    """Mirror of test_obs.py::test_histogram_quantiles_vs_numpy; the same
    stream gives the reference histogram's snapshot exactly."""
    rng = np.random.default_rng(0)
    vals = rng.uniform(0.011, 0.9, size=5000)
    per_decade = 50
    h = Histogram("h", bounds=exp_buckets(1e-2, 1.0, per_decade))
    jh = jobs.Histogram("h", bounds=jobs.exp_buckets(1e-2, 1.0, per_decade))
    for v in vals:
        h.observe(v)
        jh.observe(v)
    assert h.count == len(vals) and h.mean == pytest.approx(vals.mean())
    for q in (0.05, 0.25, 0.5, 0.9, 0.95, 0.99):
        ref = float(np.quantile(vals, q))
        assert abs(h.quantile(q) - ref) / ref < 10 ** (1 / per_decade) - 1 + 0.01, q
    snap = h.snapshot()
    assert snap["min"] == vals.min() and snap["max"] == vals.max()
    assert snap == jh.snapshot()


def test_histogram_edge_cases():
    """Mirror of test_obs.py::test_histogram_edge_cases."""
    h = Histogram("h", bounds=[1.0, 2.0, 4.0])
    assert h.quantile(0.5) is None and h.mean is None
    h.observe(1.7)
    for q in (0.0, 0.5, 1.0):
        assert h.quantile(q) == 1.7
    h2 = Histogram("h2", bounds=[1.0])
    h2.observe(5.0)
    h2.observe(7.0)
    for q in (0.1, 0.5, 0.9):
        assert 5.0 <= h2.quantile(q) <= 7.0
    assert h2.quantile(1.0) == 7.0
    h3 = Histogram("h3", bounds=[1.0, 2.0])
    for _ in range(10):
        h3.observe(1.5)
    assert h3.quantile(0.99) == 1.5


# ---------------------------------------------------------------------------
# Disabled mode: the hot-path contract
# ---------------------------------------------------------------------------

def test_disabled_registry_hands_out_shared_singletons():
    """Mirror of test_obs.py::test_disabled_registry_hands_out_shared_singletons."""
    r = Registry(enabled=False)
    assert r.counter("a") is NULL_COUNTER is r.counter("b")
    assert r.gauge("a") is NULL_GAUGE
    assert r.ewma("a") is NULL_EWMA
    assert r.histogram("a") is NULL_HISTOGRAM
    assert span("x", r) is _NULL_SPAN is span("y", None)
    NULL_COUNTER.inc()
    NULL_GAUGE.set(3.0)
    NULL_HISTOGRAM.observe(1.0)
    assert NULL_COUNTER.value == 0 and NULL_GAUGE.value is None
    assert r.snapshot() == {} and r.names() == []
    assert NULL_REGISTRY.enabled is False


def test_disabled_mode_allocates_nothing():
    """Mirror of test_obs.py::test_disabled_mode_allocates_nothing."""
    r = Registry(enabled=False)

    def loop():
        for _ in range(200):
            r.counter("train/steps").inc()
            r.gauge("train/loss").set(1.0)
            r.histogram("train/step_time_s").observe(0.01)
            with span("train/phase/step", r):
                pass

    loop()
    gc.collect()
    tracemalloc.start()
    t0 = tracemalloc.get_traced_memory()[0]
    loop()
    gc.collect()
    t1 = tracemalloc.get_traced_memory()[0]
    tracemalloc.stop()
    assert t1 - t0 < 512, f"disabled-mode loop retained {t1 - t0} bytes"


# ---------------------------------------------------------------------------
# Spans and profiling
# ---------------------------------------------------------------------------

def test_span_nesting_and_timing():
    """Mirror of test_obs.py::test_span_nesting_and_timing."""
    r = Registry()
    assert current_spans() == ()
    with span("outer", r) as outer:
        assert current_spans() == ("outer",)
        with span("inner", r):
            assert current_spans() == ("outer", "inner")
        assert current_spans() == ("outer",)
    assert current_spans() == ()
    assert r.histogram("inner").count == 1
    assert outer.seconds >= r.histogram("inner").vmax


def test_span_stack_restored_on_exception():
    """Mirror of test_obs.py::test_span_stack_restored_on_exception."""
    r = Registry()
    with pytest.raises(RuntimeError):
        with span("outer", r):
            with span("inner", r):
                raise RuntimeError("boom")
    assert current_spans() == ()
    assert r.histogram("inner").count == 1 and r.histogram("outer").count == 1


def test_profile_window_inert_without_dir():
    """Mirror of test_obs.py::test_profile_window_inert_without_dir."""
    p = ProfileWindow(None, n_steps=2)
    for s in range(5):
        p.tick(s)
    p.stop()
    p.stop()


def test_annotated_spans_are_profiler_ranges_in_the_window(tmp_path):
    """Where the reference opens a ``jax.profiler.TraceAnnotation``, an
    annotating registry's span opens a ``torch.profiler.record_function``:
    a bounded ``ProfileWindow`` captures 2 ticks, writes its Chrome trace,
    and the trace holds the spans' ranges; later ticks capture nothing."""
    r = Registry(annotate=True)
    win = ProfileWindow(str(tmp_path / "prof"), n_steps=2)
    for step in range(4):
        win.tick(step)
        with span("train/phase/step", r):
            with span("train/phase/update", r):
                torch.ones(8).add_(1.0)
    win.stop()
    assert r.histogram("train/phase/step").count == 4
    with open(win.trace_path) as f:
        names = [ev.get("name") for ev in json.load(f)["traceEvents"]]
    assert names.count("train/phase/step") == 1
    assert names.count("train/phase/update") == 1
    assert sorted(os.listdir(tmp_path / "prof")) == ["trace.json"]


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

EVENTS = [
    {"event": "compile", "step": 0, "compile_time_s": 1.2},
    {"event": "step", "step": 1, "loss": 3.5, "step_time_s": 0.01,
     "snr_proxy": 0.4, "snr_ewma": 0.41, "straggler": False},
    {"event": "gen_submit", "step": 3},
    {"event": "gen_swap", "step": 5, "old_fit_step": -1, "new_fit_step": 3,
     "fit_wall_s": 0.7, "steps_stale_at_swap": 2},
    {"event": "snr_trigger", "step": 9},
    {"event": "request", "request_id": 0, "tokens": 8, "admission_wait_s": 0.001,
     "ttft_s": 0.02, "latency_s": 0.09},
    {"event": "serve_step", "engine_step": 4, "queue_depth": 1, "active": 2,
     "page_occupancy": 0.5},
    {"event": "summary", "metrics": {}},
]


def test_jsonl_round_trip_and_schema(tmp_path):
    """Mirror of test_obs.py::test_jsonl_round_trip_and_schema; the log is
    the reference exporter's byte for byte, and each package's validator
    accepts the other's."""
    path, jpath = str(tmp_path / "m.jsonl"), str(tmp_path / "j.jsonl")
    with JsonlExporter(path) as ex, jobs.JsonlExporter(jpath) as jex:
        for ev in EVENTS:
            ex.emit(ev)
            jex.emit(ev)
    assert ex.n_events == len(EVENTS)
    ex.emit({"event": "step"})                  # closed: silent no-op
    back = read_jsonl(path)
    assert back == EVENTS
    validate_events(back)
    jobs.validate_events(back)
    with open(path) as a, open(jpath) as b:
        assert a.read() == b.read()
    for bad in ([{"event": "bogus"}], [{"event": "step", "step": 1, "loss": 2.0}],
                [{"event": "compile", "step": 0, "compile_time_s": "fast"}], []):
        with pytest.raises(AssertionError):
            validate_events(bad)


def test_pathless_exporter_is_noop():
    """Mirror of test_obs.py::test_pathless_exporter_is_noop."""
    ex = JsonlExporter(None)
    ex.emit({"event": "step", "step": 0})
    assert ex.n_events == 0
    ex.close()


def _fill(reg):
    reg.counter("train/steps").inc(7)
    reg.gauge("snr/ewma").set(0.43)
    reg.ewma("train/loss_ewma", alpha=0.5).update(2.0)
    h = reg.histogram("train/step_time_s", bounds=[0.01, 0.1, 1.0])
    h.observe(0.05)
    h.observe(0.06)
    return reg


def test_prometheus_text_and_console_summary():
    """Mirror of test_obs.py::test_prometheus_text_and_console_summary; both
    texts are the reference's for the same registry contents."""
    r, jr = _fill(Registry()), _fill(jobs.Registry())
    text = prometheus_text(r)
    for line in ("# TYPE train_steps counter", "train_steps 7", "# TYPE snr_ewma gauge",
                 "# TYPE train_step_time_s summary", 'train_step_time_s{quantile="0.5"}',
                 "train_step_time_s_count 2"):
        assert line in text
    assert text == jobs.prometheus_text(jr)
    out = console_summary(r, title="t")
    assert out.startswith("== t ==") and "train/steps" in out and "n=2" in out
    assert out == jobs.console_summary(jr, title="t")
    assert console_summary(Registry()) == "== metrics: (empty) =="


def test_metrics_server_scrape_round_trip():
    """Mirror of test_obs.py::test_metrics_server_scrape_round_trip: the
    endpoint (on localhost by default) serves the live registry; unknown
    paths 404; the port is down after close()."""
    r = Registry()
    c = r.counter("serve/requests")
    c.inc(3)
    with start_metrics_server(r, port=0) as srv:
        assert srv.port > 0
        assert srv._httpd.server_address[0] == "127.0.0.1"
        base = f"http://127.0.0.1:{srv.port}"
        body = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert body == prometheus_text(r) and "serve_requests 3" in body
        c.inc(2)
        assert "serve_requests 5" in urllib.request.urlopen(base + "/").read().decode()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/nope")
        assert e.value.code == 404
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"{base}/metrics", timeout=0.5)


def test_metrics_server_health_probes():
    """``/healthz`` answers whenever the process can, ``/readyz`` only while
    ``health_fn`` reports ready (MetricsServer's health_fn, as in the
    reference)."""
    state = {"ready": False, "queue": 3}
    with start_metrics_server(Registry(), port=0, health_fn=lambda: dict(state)) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        assert json.loads(urllib.request.urlopen(f"{base}/healthz").read()) == state
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/readyz")
        assert e.value.code == 503
        state["ready"] = True
        assert urllib.request.urlopen(f"{base}/readyz").status == 200


# ---------------------------------------------------------------------------
# Fault plans (tests/test_resilience.py, the faults core)
# ---------------------------------------------------------------------------

def test_plan_fires_at_exact_nth():
    """Mirror of test_resilience.py::test_plan_fires_at_exact_nth."""
    plan = FaultPlan([Fault("a/site", 2, "raise")])
    with faults.install(plan) as reg:
        faults.fire("a/site")
        faults.fire("a/site")
        with pytest.raises(InjectedFault) as exc:
            faults.fire("a/site")
        assert (exc.value.site, exc.value.nth) == ("a/site", 2)
        faults.fire("a/site")
        assert reg.count("a/site") == 4
        assert reg.fired == [plan.get("a/site", 2)]
    assert faults.active() is None


def test_install_is_scoped_and_nests():
    """Mirror of test_resilience.py::test_install_is_scoped_and_nests."""
    assert faults.active() is None
    with faults.install(FaultPlan()) as outer:
        assert faults.active() is outer
        with faults.install(FaultPlan()) as inner:
            assert faults.active() is inner
        assert faults.active() is outer
    assert faults.active() is None


def test_install_restored_on_exception():
    """Mirror of test_resilience.py::test_install_restored_on_exception."""
    with pytest.raises(ValueError):
        with faults.install(FaultPlan()):
            raise ValueError("boom")
    assert faults.active() is None


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_corrupt_poisons_copy_not_original(kind):
    """Mirror of test_resilience.py::test_corrupt_poisons_copy_not_original,
    for numpy batches and for tensor batches (the port's)."""
    if kind == "numpy":
        batch = {"tokens": np.arange(6, dtype=np.int32), "mask": np.ones(6, np.float32)}
    else:
        batch = {"tokens": torch.arange(6), "mask": torch.ones(3, 2).t()}
    with faults.install(FaultPlan([Fault("t/b", 0, "corrupt")])):
        out = faults.inject("t/b", batch)
    assert np.isnan(np.asarray(out["mask"])).any()
    assert not np.isnan(np.asarray(batch["mask"])).any(), "original must be untouched"
    np.testing.assert_array_equal(np.asarray(out["tokens"]), np.asarray(batch["tokens"]))
    assert type(out["mask"]) is type(batch["mask"])


def test_delay_sleeps_roughly_requested():
    """Mirror of test_resilience.py::test_delay_sleeps_roughly_requested."""
    t0 = time.perf_counter()
    with faults.install(FaultPlan([Fault("d", 0, "delay", seconds=0.05)])):
        faults.fire("d")
    assert time.perf_counter() - t0 >= 0.04


def test_plan_json_roundtrip_and_random_plan_determinism():
    """Mirror of test_resilience.py::test_plan_json_roundtrip_and_random_plan_determinism;
    a seeded random plan is the reference's, JSON for JSON."""
    plan = faults.random_plan(7, ["x", "y"], 5)
    assert plan.to_json() == faults.random_plan(7, ["x", "y"], 5).to_json()
    assert plan.to_json() == jfaults.random_plan(7, ["x", "y"], 5).to_json()
    back = FaultPlan.from_json(plan.to_json())
    assert sorted(back.faults, key=str) == sorted(plan.faults, key=str)


def test_env_var_plan_installs_in_subprocess():
    """Mirror of test_resilience.py::test_env_var_plan_installs_in_subprocess,
    under the reference's variable name (REPRO_FAULT_PLAN)."""
    plan = FaultPlan([Fault("sub/site", 0, "raise")])
    code = ("from repro_torch.resilience import faults\n"
            "assert faults.active() is not None\n"
            "try:\n"
            "    faults.fire('sub/site')\n"
            "except faults.InjectedFault:\n"
            "    print('FIRED')\n")
    env = dict(os.environ, REPRO_FAULT_PLAN=plan.to_json(), PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FIRED" in out.stdout


def test_disabled_injection_is_cheap():
    """Mirror of test_resilience.py::test_disabled_injection_is_cheap."""
    assert faults.active() is None
    t0 = time.perf_counter()
    for _ in range(200_000):
        faults.fire("hot/site")
    assert time.perf_counter() - t0 < 1.0
