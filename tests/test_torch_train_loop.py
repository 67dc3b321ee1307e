"""The port's fault-tolerant training loop, torch only: the cases of
``tests/test_train_loop.py``, the refresher and training chaos cases of
``tests/test_resilience.py``, ``tests/test_obs.py``'s documented training
metrics, the snapshot a background fit reads, the launcher and the example,
on reduced stablelm-3b (one layer, float32) on the CPU.

The reference's bit-exact claims (restart, rollback replay, retried fits)
are held bit for bit, torch against torch.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import configs as cfg_lib
from repro_torch import tree_util
from repro_torch.data import lm_batch_fn
from repro_torch.genfit.refresh import AsyncRefresher, RefreshTimeout
from repro_torch.models import lm_head
from repro_torch.obs import Registry
from repro_torch.obs.export import read_jsonl, validate_events
from repro_torch.optim import OptimizerConfig
from repro_torch.resilience import faults
from repro_torch.resilience.faults import Fault, FaultPlan
from repro_torch.train import (LoopConfig, Preemption, StragglerMonitor, init_train_state,
                               make_train_step, run_loop)
from repro_torch.train.generator_fit import (collect_features, fit_lm_generator,
                                             make_gen_fit_fn)
from repro_torch.train.loop import _fit_snapshot


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The model here is tiny: one thread per op is as fast, and leaves the
    other test workers' cores alone (the default spins a thread per core
    in every op)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    return dataclasses.replace(cfg_lib.reduced_config("stablelm-3b"), num_layers=1,
                               dtype="float32")


def _batch_fn(cfg, seed):
    make = lm_batch_fn(cfg.vocab_size, global_batch=4, seq_len=16, seed=seed)
    return lambda s: {k: torch.as_tensor(v) for k, v in make(s).items()}


def _setup(head_kind="adversarial_ns", seed=0, skip_nonfinite=False):
    cfg = _cfg()
    hcfg = lm_head.head_config(cfg, head_kind, reg=1e-4)
    opt = OptimizerConfig(name="adagrad", learning_rate=0.05, clip_norm=1.0)
    state = init_train_state(torch.Generator().manual_seed(seed), cfg, opt, head_kind,
                             device="cpu")
    step_fn = make_train_step(cfg, hcfg, opt, skip_nonfinite=skip_nonfinite)
    return cfg, state, step_fn, _batch_fn(cfg, 1)


def _gen_fit_fn(cfg):
    """Deterministic snapshot fit (levelwise first, warm-start after)."""
    return make_gen_fit_fn(cfg, _batch_fn(cfg, 9), kind="adversarial_ns",
                           max_tokens=128, n_batches=2)


def _assert_trees_equal(a, b):
    la, sa = tree_util.flatten(a)
    lb, sb = tree_util.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


# ---------------------------------------------------------------------------
# tests/test_train_loop.py
# ---------------------------------------------------------------------------

def test_loss_decreases():
    cfg, state, step_fn, batch_fn = _setup()
    loop = LoopConfig(total_steps=40, checkpoint_dir=None, log_every=100)
    state, hist = run_loop(state, step_fn, batch_fn, loop, 2)
    assert np.mean(hist["loss"][-5:]) < np.mean(hist["loss"][:5])


def test_preemption_restart_bit_exact(tmp_path):
    """20 steps straight against 10 / preempt / restart / 10: the final
    parameters and optimizer state are bit-identical."""
    loop_full = LoopConfig(total_steps=20, checkpoint_every=5,
                           checkpoint_dir=str(tmp_path / "a"))
    cfg, state_a, step_fn, batch_fn = _setup(seed=3)
    state_a, _ = run_loop(state_a, step_fn, batch_fn, loop_full, 7)

    loop_b = LoopConfig(total_steps=20, checkpoint_every=5,
                        checkpoint_dir=str(tmp_path / "b"))
    _, state_b, _, _ = _setup(seed=3)
    pre = Preemption()

    def on_step(step, metrics):
        if step == 9:
            pre.trigger()

    _, hist_b = run_loop(state_b, step_fn, batch_fn, loop_b, 7, preemption=pre,
                         on_step=on_step)
    assert hist_b["preempted_at"] == 10
    _, state_b2, _, _ = _setup(seed=3)   # a fresh process: overwritten on resume
    state_b2, _ = run_loop(state_b2, step_fn, batch_fn, loop_b, 7)
    assert state_b2.step == 20
    _assert_trees_equal(state_a.params, state_b2.params)
    _assert_trees_equal(state_a.opt_state, state_b2.opt_state)


def test_straggler_monitor():
    m = StragglerMonitor(factor=3.0, alpha=0.5)
    for _ in range(10):
        assert not m.observe(0.1)
    assert m.observe(1.0)          # 10x the EWMA -> flagged
    assert m.flagged == 1
    assert not m.observe(0.1)      # baseline not polluted by the outlier


def test_generator_refresh_changes_head_state():
    cfg, state, step_fn, batch_fn = _setup()
    make = lm_batch_fn(cfg.vocab_size, global_batch=4, seq_len=16, seed=9)

    def gen_fit(st):
        return fit_lm_generator(st.params, cfg, (make(i) for i in range(2)),
                                max_tokens=128)

    before = state.head_state.gen.tree.w.clone()
    state, _ = run_loop(state, step_fn, batch_fn, LoopConfig(total_steps=6,
                                                             gen_warmup_steps=2),
                        0, gen_fit_fn=gen_fit)
    after = state.head_state.gen.tree.w
    assert before.shape == after.shape
    assert not torch.allclose(before, after)
    assert state.gen_fit_step == 2


def test_async_refresh_swaps_at_recorded_step(tmp_path):
    cfg, state, step_fn, batch_fn = _setup()
    loop = LoopConfig(total_steps=12, gen_warmup_steps=3, gen_refresh_steps=6,
                      gen_async=True, gen_swap_delay=2,
                      checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4)
    state, hist = run_loop(state, step_fn, batch_fn, loop, 0, gen_fit_fn=_gen_fit_fn(cfg))
    assert hist["gen_submit_steps"] == [3, 9]
    assert hist["gen_swap_steps"] == [5, 11]
    assert state.gen_fit_step == 9
    assert hist["step"] == list(range(12))


def test_async_refresh_resume_bit_exact(tmp_path):
    """Preempted inside the submit→swap window: the resumed run replays the
    fit from the persisted snapshot and ends bit-identical."""
    def build(tag):
        cfg, state, step_fn, batch_fn = _setup(seed=3)
        loop = LoopConfig(total_steps=14, checkpoint_every=3,
                          checkpoint_dir=str(tmp_path / tag), gen_warmup_steps=4,
                          gen_refresh_steps=0, gen_async=True, gen_swap_delay=4)
        return cfg, state, step_fn, batch_fn, loop

    cfg, state_a, step_fn, batch_fn, loop_a = build("a")
    gen_fit = _gen_fit_fn(cfg)
    state_a, hist_a = run_loop(state_a, step_fn, batch_fn, loop_a, 7, gen_fit_fn=gen_fit)
    assert hist_a["gen_swap_steps"] == [8]

    cfg, state_b, step_fn, batch_fn, loop_b = build("b")
    pre = Preemption()

    def trigger(step, metrics):
        if step == 5:
            pre.trigger()

    _, hist_b = run_loop(state_b, step_fn, batch_fn, loop_b, 7, gen_fit_fn=gen_fit,
                         preemption=pre, on_step=trigger)
    assert hist_b["preempted_at"] == 6
    assert "gen_swap_steps" not in hist_b

    _, state_b2, _, _ = _setup(seed=3)
    state_b2, hist_b2 = run_loop(state_b2, step_fn, batch_fn, loop_b, 7,
                                 gen_fit_fn=gen_fit)
    assert hist_b2["gen_swap_steps"] == [8]
    _assert_trees_equal(state_a.as_pytree(), state_b2.as_pytree())


def test_async_refresh_does_not_stall_steps():
    """A slow background fit must not spike the step time while it is in
    flight: the loop blocks only at the recorded swap step. The port's fit
    is host code that shares the interpreter lock with the training
    thread, so the fit here is a sleep that returns a head state fitted
    beforehand: the steps wait on the loop's protocol alone, never on the
    fit's own host work."""
    cfg, state, step_fn, batch_fn = _setup()
    fitted = _gen_fit_fn(cfg)(state)
    fit_s = 4.0

    def slow_fit(st):
        time.sleep(fit_s)
        return fitted

    loop = LoopConfig(total_steps=10, gen_warmup_steps=2, gen_refresh_steps=0,
                      gen_async=True, gen_swap_delay=7)
    times = {}
    state, hist = run_loop(state, step_fn, batch_fn, loop, 1, gen_fit_fn=slow_fit,
                           on_step=lambda s, m: times.__setitem__(s, m["step_time"]))
    assert hist["gen_swap_steps"] == [9]
    in_flight = [times[s] for s in range(3, 9)]
    assert max(in_flight) < 0.9 * fit_s, in_flight


def test_snr_refresh_triggers_on_drift_not_on_fresh():
    """``--gen-refresh-mode snr``: after an induced label drift the online
    signal-mass EWMA falls below threshold x the post-install reference and
    the loop refits; the undrifted control run never triggers."""
    drift_at = 36
    loop = LoopConfig(total_steps=64, gen_warmup_steps=20, gen_refresh_mode="snr",
                      snr_threshold=0.4, snr_patience=12)

    def run(drifting):
        cfg, state, step_fn, batch_fn = _setup()

        def drifted(s):
            b = batch_fn(s)
            if drifting and s >= drift_at:
                b = {**b, "labels": b["labels"] % 8}
            return b

        _, hist = run_loop(state, step_fn, drifted, loop, 2, gen_fit_fn=_gen_fit_fn(cfg))
        return hist

    hist = run(drifting=True)
    triggers = hist["snr_trigger_steps"]
    assert triggers, "drift did not trigger a refresh"
    assert all(t >= drift_at for t in triggers), (triggers, drift_at)
    assert hist["gen_swap_steps"] == [loop.gen_warmup_steps] + triggers
    control = run(drifting=False)
    assert "snr_trigger_steps" not in control, control["snr_trigger_steps"]
    assert control["gen_swap_steps"] == [loop.gen_warmup_steps]


def test_collect_features_cap_and_ragged_batches():
    """Collection stops requesting batches at the cap; a ragged final batch's
    rows are bit for bit those of its own forward (the port runs each batch
    at its own shape, so nothing is padded)."""
    import itertools

    cfg, state, _, _ = _setup()
    make = lm_batch_fn(cfg.vocab_size, global_batch=4, seq_len=16, seed=2)
    b0 = make(0)
    ragged = {k: v[:2] for k, v in b0.items()}
    h, y = collect_features(state.params, cfg, [b0, ragged], max_tokens=80)
    assert h.shape == (80, cfg.d_model) and y.shape == (80,)
    h_full, _ = collect_features(state.params, cfg, [b0], max_tokens=64)
    np.testing.assert_array_equal(h[:64], h_full)
    h_rag, y_rag = collect_features(state.params, cfg, [ragged], max_tokens=32)
    np.testing.assert_array_equal(h[64:80], h_rag[:16])
    np.testing.assert_array_equal(y[64:80], y_rag[:16])
    requested = []

    def stream():
        for i in itertools.count():
            requested.append(i)
            yield make(i)

    h_cap, y_cap = collect_features(state.params, cfg, stream(), max_tokens=100)
    assert h_cap.shape == (100, cfg.d_model) and y_cap.shape == (100,)
    assert requested == [0, 1]


def test_fit_snapshot_is_not_touched_by_later_steps():
    """The port's step writes params in place; the background fit's snapshot
    owns its storage and keeps the submit-time values."""
    cfg, state, step_fn, batch_fn = _setup()
    want = state.params["embed"].clone()
    snap = _fit_snapshot(state)
    assert snap.params["embed"].data_ptr() != state.params["embed"].data_ptr()
    state, _ = step_fn(state, batch_fn(0), torch.Generator().manual_seed(0))
    assert not torch.equal(state.params["embed"], want)
    assert torch.equal(snap.params["embed"], want)
    assert snap.gen_fit_step == -1


# ---------------------------------------------------------------------------
# tests/test_resilience.py: the refresher and the loop's degradation ladder
# ---------------------------------------------------------------------------

def test_refresher_retries_absorb_transient_failure():
    calls = []

    def flaky(state):
        calls.append(state)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "fitted"

    r = AsyncRefresher(flaky, retries=2, backoff_s=0.001)
    r.submit("snap", 5)
    assert r.result() == ("fitted", 5)
    assert len(calls) == 3


def test_refresher_exhausted_retries_raise_last_error():
    def always(state):
        raise RuntimeError("permanent")

    r = AsyncRefresher(always, retries=1, backoff_s=0.001)
    r.submit("snap", 5)
    with pytest.raises(RuntimeError, match="permanent"):
        r.result()
    assert not r.in_flight
    assert r.submit_step == 5


def test_refresher_watchdog_abandons_hung_fit():
    release = []

    def hung(state):
        while not release:
            time.sleep(0.01)
        return "late"

    r = AsyncRefresher(hung, timeout_s=0.2)
    r.submit("snap", 3)
    with pytest.raises(RefreshTimeout):
        r.result()
    assert not r.in_flight
    r.submit("snap2", 9)
    r._fit_fn = lambda state: "fresh"
    release.append(True)
    _, step = r.result()
    assert step == 9


def test_nonfinite_skip_counts_and_completes(tmp_path):
    cfg, state, step_fn, batch_fn = _setup(seed=2, skip_nonfinite=True)
    jsonl = str(tmp_path / "ev.jsonl")
    loop = LoopConfig(total_steps=8, checkpoint_dir=None, log_every=100,
                      metrics_jsonl=jsonl)
    with faults.install(FaultPlan([Fault("train/batch", 3, "corrupt")])) as reg:
        state, hist = run_loop(state, step_fn, batch_fn, loop, 2, registry=Registry())
    assert reg.count("train/batch") == 8
    assert hist["nonfinite_steps"] == [3]
    assert hist["metrics"]["train/nonfinite_skipped"]["value"] == 1
    assert np.isfinite(hist["loss"][-1])
    events = read_jsonl(jsonl)
    validate_events(events)
    assert [e["step"] for e in events if e["event"] == "nonfinite_skip"] == [3]


def test_rollback_replay_is_bit_equal_to_fault_free(tmp_path):
    n = 10
    cfg, ref_state, step_fn, batch_fn = _setup(seed=3, skip_nonfinite=True)
    ref_state, _ = run_loop(ref_state, step_fn, batch_fn,
                            LoopConfig(total_steps=n, checkpoint_dir=None), 7)
    loop = LoopConfig(total_steps=n, checkpoint_every=2,
                      checkpoint_dir=str(tmp_path / "ck"), log_every=100,
                      max_consecutive_nonfinite=1, max_rollbacks=2)
    _, state, _, _ = _setup(seed=3)
    with faults.install(FaultPlan([Fault("train/batch", 5, "corrupt")])):
        state, hist = run_loop(state, step_fn, batch_fn, loop, 7, registry=Registry())
    assert hist["rollback_steps"] == [[5, 4]]
    assert hist["metrics"]["train/rollbacks"]["value"] == 1
    _assert_trees_equal(ref_state.params, state.params)
    _assert_trees_equal(ref_state.opt_state, state.opt_state)


def test_unguarded_nonfinite_rolls_back_immediately(tmp_path):
    n = 8
    cfg, state0, unguarded, batch_fn = _setup(seed=4)
    ref_state, _ = run_loop(state0, unguarded, batch_fn,
                            LoopConfig(total_steps=n, checkpoint_dir=None), 5)
    _, fresh, _, _ = _setup(seed=4)
    loop = LoopConfig(total_steps=n, checkpoint_every=2,
                      checkpoint_dir=str(tmp_path / "ck"), log_every=100)
    with faults.install(FaultPlan([Fault("train/batch", 5, "corrupt")])):
        state, hist = run_loop(fresh, unguarded, batch_fn, loop, 5)
    assert hist["rollback_steps"] == [[5, 4]]
    _assert_trees_equal(ref_state.params, state.params)


def test_rollback_budget_exhaustion_raises(tmp_path):
    cfg, state, step_fn, batch_fn = _setup(seed=5, skip_nonfinite=True)
    plan = FaultPlan([Fault("train/batch", n, "corrupt") for n in range(2, 64)])
    loop = LoopConfig(total_steps=8, checkpoint_every=2,
                      checkpoint_dir=str(tmp_path / "ck"), log_every=100,
                      max_consecutive_nonfinite=1, max_rollbacks=2)
    with faults.install(plan):
        with pytest.raises(FloatingPointError, match="budget"):
            run_loop(state, step_fn, batch_fn, loop, 2)


def test_nonfinite_policy_raise_fails_fast():
    cfg, state, step_fn, batch_fn = _setup(seed=6, skip_nonfinite=True)
    loop = LoopConfig(total_steps=6, checkpoint_dir=None, nonfinite_policy="raise")
    with faults.install(FaultPlan([Fault("train/batch", 2, "corrupt")])):
        with pytest.raises(FloatingPointError):
            run_loop(state, step_fn, batch_fn, loop, 2)


def test_genfit_transient_failure_retried_bit_equal():
    n = 6
    cfg, state, step_fn, batch_fn = _setup(seed=7, skip_nonfinite=True)
    gen_fit = _gen_fit_fn(cfg)
    loop = LoopConfig(total_steps=n, gen_warmup_steps=2, gen_fit_retries=2,
                      gen_fit_backoff_s=0.001)
    ref_state, ref_hist = run_loop(state, step_fn, batch_fn, loop, 3, gen_fit_fn=gen_fit)
    _, state2, _, _ = _setup(seed=7)
    with faults.install(FaultPlan([Fault("genfit/fit", 0, "raise")])) as r:
        state2, hist = run_loop(state2, step_fn, batch_fn, loop, 3, gen_fit_fn=gen_fit)
    assert r.count("genfit/fit") == 2
    assert "gen_refresh_failed_steps" not in hist
    assert hist["gen_swap_steps"] == ref_hist["gen_swap_steps"]
    _assert_trees_equal(ref_state.params, state2.params)
    _assert_trees_equal(ref_state.head_state, state2.head_state)


def test_genfit_permanent_failure_keeps_stale_generator():
    cfg, state, step_fn, batch_fn = _setup(seed=8, skip_nonfinite=True)
    loop = LoopConfig(total_steps=10, gen_warmup_steps=2, gen_refresh_steps=3,
                      gen_fit_retries=1, gen_fit_backoff_s=0.001)
    plan = FaultPlan([Fault("genfit/fit", 0, "raise"), Fault("genfit/fit", 1, "raise")])
    with faults.install(plan):
        state, hist = run_loop(state, step_fn, batch_fn, loop, 3,
                               gen_fit_fn=_gen_fit_fn(cfg), registry=Registry())
    assert hist["gen_refresh_failed_steps"] == [2]
    assert 5 in hist["gen_swap_steps"]
    assert hist["metrics"]["genfit/refresh_failed"]["value"] == 1
    assert np.isfinite(hist["loss"][-1])


def test_genfit_async_hang_watchdog_keeps_training(tmp_path):
    cfg, state, step_fn, batch_fn = _setup(seed=9, skip_nonfinite=True)
    loop = LoopConfig(total_steps=10, gen_warmup_steps=2, gen_refresh_steps=4,
                      gen_async=True, gen_swap_delay=2,
                      checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4,
                      gen_fit_retries=0, gen_fit_timeout_s=10.0)
    plan = FaultPlan([Fault("genfit/fit", 0, "hang", seconds=1200.0)])
    with faults.install(plan):
        state, hist = run_loop(state, step_fn, batch_fn, loop, 3,
                               gen_fit_fn=_gen_fit_fn(cfg), registry=Registry())
    assert hist["gen_refresh_failed_steps"] == [4]
    assert hist["gen_swap_steps"] == [8]
    assert state.gen_fit_step == 6
    assert np.isfinite(hist["loss"][-1])


def test_checkpoint_delay_schedule_is_bit_equal(tmp_path):
    from repro_torch.checkpoint import latest_step
    n = 8
    cfg, ref_state, step_fn, batch_fn = _setup(seed=10, skip_nonfinite=True)
    ref_state, _ = run_loop(ref_state, step_fn, batch_fn,
                            LoopConfig(total_steps=n, checkpoint_dir=None), 4)
    loop = LoopConfig(total_steps=n, checkpoint_every=2, checkpoint_dir=str(tmp_path / "ck"))
    _, state, _, _ = _setup(seed=10)
    plan = FaultPlan([Fault("checkpoint/write", 0, "delay", seconds=0.02),
                      Fault("checkpoint/commit", 1, "delay", seconds=0.02)])
    with faults.install(plan):
        state, _ = run_loop(state, step_fn, batch_fn, loop, 4)
    _assert_trees_equal(ref_state.params, state.params)
    assert latest_step(str(tmp_path / "ck")) == n


# ---------------------------------------------------------------------------
# tests/test_obs.py: the documented training metrics
# ---------------------------------------------------------------------------

def test_train_loop_emits_documented_metrics(tmp_path):
    cfg, state, step_fn, batch_fn = _setup()
    path = str(tmp_path / "train.jsonl")
    total = 6
    loop = LoopConfig(total_steps=total, gen_warmup_steps=2, gen_async=True,
                      gen_swap_delay=2, metrics_jsonl=path, metrics_interval=1)
    reg = Registry()
    _, hist = run_loop(state, step_fn, batch_fn, loop, 2, gen_fit_fn=_gen_fit_fn(cfg),
                       registry=reg)
    assert hist["compile_time_s"] > 0
    assert len(hist["step_times"]) == total - 1
    assert hist["compile_time_s"] not in hist["step_times"]
    snap = hist["metrics"]
    for name in ("train/steps", "train/loss", "train/step_time_s",
                 "train/compile_time_s", "train/phase/data", "train/phase/step",
                 "snr/proxy", "snr/ewma", "genfit/submits", "genfit/swaps",
                 "genfit/fit_wall_s", "genfit/staleness_at_swap",
                 "train/head_state_bytes"):
        assert name in snap, f"missing documented metric {name}"
    assert snap["train/steps"]["value"] == total
    assert snap["train/step_time_s"]["count"] == total - 1
    assert snap["genfit/swaps"]["value"] == 1
    assert snap == reg.snapshot()
    events = read_jsonl(path)
    validate_events(events)
    by = {}
    for ev in events:
        by.setdefault(ev["event"], []).append(ev)
    assert [e["step"] for e in by["step"]] == list(range(1, total))
    assert all("snr_proxy" in e and "snr_ewma" in e for e in by["step"])
    assert [e["step"] for e in by["gen_submit"]] == [2]
    assert [e["step"] for e in by["gen_swap"]] == [4]


# ---------------------------------------------------------------------------
# The launcher and the example
# ---------------------------------------------------------------------------

def test_launch_train_main_on_cpu(capsys):
    from repro_torch.launch import train as launch
    state, hist = launch.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                               "--steps", "3", "--batch", "2", "--seq", "16",
                               "--gen-warmup", "1"])
    out = capsys.readouterr().out
    assert "final loss" in out
    assert state.step == 3 and hist["gen_swap_steps"] == [1]
    assert all(np.isfinite(hist["loss"]))


def test_launch_train_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import train as launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.main(["--steps", "1", "--batch", "2", "--seq", "8"])


def test_example_train_lm_torch_on_cpu(capsys):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--steps", "40", "--gen-async"])
    out = capsys.readouterr().out
    assert "OK" in out and "eval (debiased)" in out
