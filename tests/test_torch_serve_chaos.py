"""The port's engine under fault injection and its observability, mirrored
from the six engine cases of ``tests/test_resilience.py`` (bounded queue
shedding, deadline aborts, poisoned-prefill isolation through
``repro_torch.resilience.faults``, seeded chaos without leaks, the health
snapshot, the readiness gate on the metrics server) and from
``tests/test_obs.py::test_engine_emits_latency_histograms_and_events``
(latency histograms, phase spans and the JSONL event stream)."""
import json
import urllib.error
import urllib.request

import numpy as np
import torch
from _hypothesis_compat import given, settings, strategies as st
from _torch_serve_common import CFG, HCFG, HEAD_STATE, PARAMS, one_thread  # noqa: F401

from repro_torch.obs import JsonlExporter, start_metrics_server
from repro_torch.obs.export import read_jsonl, validate_events
from repro_torch.resilience import faults
from repro_torch.resilience.faults import Fault, FaultPlan
from repro_torch.serve import Engine, Request, ServeConfig

MAX_LEN = 12
N_SLOTS = 2
_ENGINES = {}


def shared_engine(max_queue=0, enforce_deadlines=False) -> Engine:
    """One engine per resilience config; between runs all lanes and pages
    are free and the queues empty."""
    key = (max_queue, enforce_deadlines)
    if key not in _ENGINES:
        _ENGINES[key] = Engine(CFG, HCFG, PARAMS, HEAD_STATE, ServeConfig(
            n_slots=N_SLOTS, max_len=MAX_LEN, beam=8, page_len=3, n_pages=8,
            cache_dtype=torch.float32, max_queue=max_queue,
            enforce_deadlines=enforce_deadlines))
    return _ENGINES[key]


def _prompts(seed, n, lo=2, hi=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, rng.integers(lo, hi + 1)).astype(np.int32)
            for _ in range(n)]


def _assert_drained(eng):
    eng.pool.check_invariants()
    assert eng.pool.num_free_lanes == N_SLOTS
    assert eng.pool.num_free_pages == eng.pool.n_pages
    assert eng.num_pending == 0 and eng.num_active == 0


def test_engine_shed_on_bounded_queue():
    eng = shared_engine(max_queue=2)
    before = eng.shed_count
    handles = [eng.submit(Request(prompt=p, max_new_tokens=3)) for p in _prompts(0, 5)]
    shed = [h for h in handles if h.status == "shed"]
    assert len(shed) == 3 and eng.shed_count - before == 3
    assert all(h.done and not h.tokens for h in shed)
    eng.run()
    assert all(h.done for h in handles)
    kept = [h for h in handles if h.status == "ok"]
    assert len(kept) == 2 and all(len(h.tokens) == 3 for h in kept)
    _assert_drained(eng)
    assert eng.health()["ready"]


def test_engine_deadline_abort_reclaims_resources():
    eng = shared_engine(enforce_deadlines=True)
    expired = [eng.submit(Request(prompt=p, max_new_tokens=3, deadline_s=0.0))
               for p in _prompts(1, 3)]
    alive = eng.submit(Request(prompt=_prompts(2, 1)[0], max_new_tokens=3))
    eng.run()
    assert all(h.done and h.status == "deadline" for h in expired)
    assert alive.status == "ok" and len(alive.tokens) == 3
    assert eng.deadline_aborts >= 3
    _assert_drained(eng)


def test_engine_poisoned_prefill_is_isolated():
    """A request whose prefill raises is failed alone; the rest of the
    batch completes with the tokens of a fault-free run."""
    eng = shared_engine()
    ps = _prompts(3, 4)
    ref = [eng.submit(Request(prompt=p, max_new_tokens=3)) for p in ps]
    eng.run()
    _assert_drained(eng)
    with faults.install(FaultPlan([Fault("serve/prefill", 1, "raise")])):
        handles = [eng.submit(Request(prompt=p, max_new_tokens=3)) for p in ps]
        eng.run()
    assert all(h.done for h in handles)
    errored = [i for i, h in enumerate(handles) if h.status == "error"]
    assert len(errored) == 1
    for i, h in enumerate(handles):
        if h.status == "ok":
            assert h.tokens == ref[i].tokens, f"request {i} diverged"
    _assert_drained(eng)
    assert eng.poisoned_count >= 1


@settings(max_examples=5, deadline=None)
@given(seed=st.integers(0, 10 ** 6))
def test_engine_never_leaks_under_chaos(seed):
    rng = np.random.default_rng(seed)
    plan_faults = []
    for _ in range(int(rng.integers(1, 5))):
        plan_faults.append(Fault("serve/prefill", int(rng.integers(0, 6)),
                                 str(rng.choice(["raise", "delay"])), seconds=0.002))
    for _ in range(int(rng.integers(0, 3))):
        plan_faults.append(Fault("serve/step", int(rng.integers(0, 8)), "delay",
                                 seconds=0.002))
    eng = shared_engine(enforce_deadlines=True)
    ps = _prompts(seed, int(rng.integers(2, 6)))
    with faults.install(FaultPlan(plan_faults)):
        handles = []
        for p in ps:
            ddl = 0.0 if rng.random() < 0.3 else None
            handles.append(eng.submit(Request(
                prompt=p, max_new_tokens=int(rng.integers(1, 4)), deadline_s=ddl)))
        eng.run()
    assert all(h.done for h in handles)
    assert all(h.status in ("ok", "error", "deadline", "shed") for h in handles)
    _assert_drained(eng)


def test_engine_health_snapshot_in_stats():
    h = shared_engine().stats()["health"]
    for k in ("ready", "compiled", "queue_depth", "active", "lanes_free", "pages_free",
              "shed", "poisoned", "deadline_aborts"):
        assert k in h, k
    assert h["queue_depth"] == 0 and h["active"] == 0


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_engine_readyz_flips_after_compile():
    """Readiness waits for the first launch (on the card it builds the
    kernels)."""
    eng = shared_engine()
    eng._compiled = False
    with start_metrics_server(eng.registry, 0, host="127.0.0.1",
                              health_fn=eng.health) as srv:
        assert _get(srv.port, "/readyz")[0] == 503
        h = eng.submit(Request(prompt=_prompts(9, 1)[0], max_new_tokens=2))
        eng.run()
        assert h.status == "ok"
        code, body = _get(srv.port, "/readyz")
        assert code == 200 and json.loads(body)["compiled"] is True


def test_engine_emits_latency_histograms_and_events(tmp_path):
    path = str(tmp_path / "serve.jsonl")
    ex = JsonlExporter(path)
    engine = Engine(CFG, HCFG, PARAMS, HEAD_STATE,
                    ServeConfig(n_slots=2, max_len=12, beam=8, cache_dtype=torch.float32),
                    exporter=ex, metrics_interval=1)
    rng = np.random.default_rng(3)
    n_req, gen = 3, 4
    handles = [engine.submit(Request(
        prompt=rng.integers(0, CFG.vocab_size, 4).astype(np.int32), max_new_tokens=gen))
        for _ in range(n_req)]
    engine.run()
    ex.close()
    assert all(len(h.tokens) == gen for h in handles)
    stats = engine.stats()
    lat = stats["latency"]
    for key in ("admission_wait", "ttft", "total"):
        assert lat[key]["count"] == n_req, (key, lat[key])
        assert lat[key]["p50"] is not None
    assert lat["total"]["min"] >= lat["ttft"]["min"]
    assert stats["tokens"] == n_req * gen
    snap = stats["metrics"]
    for name in ("serve/admission_wait_s", "serve/ttft_s", "serve/latency_s",
                 "serve/tokens", "serve/queue_depth", "serve/active",
                 "serve/page_occupancy", "serve/phase/prefill", "serve/phase/decode",
                 "serve/decode_steps", "serve/completed"):
        assert name in snap, f"missing documented metric {name}"
    assert snap["serve/tokens"]["value"] == n_req * gen
    events = read_jsonl(path)
    validate_events(events)
    by = {}
    for ev in events:
        by.setdefault(ev["event"], []).append(ev)
    assert len(by["request"]) == n_req
    for ev in by["request"]:
        assert 0 <= ev["ttft_s"] <= ev["latency_s"]
        assert ev["tokens"] == gen
    assert by["serve_step"], "no serve_step samples"
    assert all(ev["queue_depth"] >= 0 and 0 <= ev["page_occupancy"] <= 1
               for ev in by["serve_step"])
