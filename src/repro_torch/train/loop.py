"""Fault-tolerant training loop, as ``repro.train.loop``.

Production behaviours, all exercised by tests:
  * periodic atomic checkpoints + auto-resume (bit-exact restart);
  * preemption handling: SIGTERM (or an injected callback) triggers an
    immediate checkpoint and a clean exit — the restart continues from the
    exact step (simulated preemption in tests/test_train_loop.py);
  * straggler monitor: per-step wall-time EWMA; steps slower than
    ``straggler_factor`` x EWMA are counted and logged — at fleet scale this
    signal feeds the controller that re-schedules slow hosts;
  * deterministic data: the loader is stateless in (seed, step), so restart
    only needs the step counter;
  * generator refresh: the adversarial tree is (re)fitted from a model
    snapshot every ``gen_refresh_steps`` (0 = fit once at
    ``gen_warmup_steps``). With ``gen_async`` the fit runs in a background
    thread (repro.genfit.refresh) while training continues on the stale
    generator, and the new generator is swapped in at the *recorded* step
    ``submit + gen_swap_delay`` — a pure function of the config, so
    checkpoint/resume replays the exact swap and stays bit-exact (the
    submit-time state is persisted as a ``gensnap`` artifact and the fit,
    being deterministic, is re-run on resume if it was in flight). The
    training step updates the parameters in place, so the fit reads a
    clone of them taken on the training thread (:func:`_fit_snapshot`);
  * SNR-driven refresh (``gen_refresh_mode="snr"``): instead of a fixed
    period, a refresh is submitted when the online gradient-SNR proxy
    tracked in ``TrainState.snr_ewma`` degrades below ``snr_threshold`` x
    the post-install reference (genfit.refresh.refresh_on_snr). The
    trigger reads only checkpointed state, so resume
    replays the same trigger steps; the data-dependent submit step is
    recovered from the gensnap artifact on resume.
  * graceful degradation: non-finite steps are skipped
    (``nonfinite_policy="skip"`` + the step's ``skip_nonfinite`` guard,
    which checks before any write)
    and, past ``max_consecutive_nonfinite``, answered with a rollback-
    restore from the newest verifiable checkpoint and a deterministic
    replay; a failed or hung generator fit (retries + watchdog in
    ``AsyncRefresher``) keeps the stale generator and re-arms the SNR
    trigger instead of killing the run.

Randomness: step ``s`` samples from a ``torch.Generator`` seeded from
(``seed``, ``s``) on the parameters' device, so a resumed run draws what
the uninterrupted one drew. The port's row sums are deterministic
(:mod:`repro_torch.optim.sparse`), so a resume on the card is bit-exact too.

Under a ``("data", "model")`` mesh (``mesh=``) every rank runs this loop
on its local state (:func:`repro_torch.parallel.shard_train_state`) and
the global batches. Every host decision that may differ between ranks is
agreed on, since ranks that decide differently call different
collectives and hang: a fit's outcome (a failure, a retry exhausted, the
watchdog) counts as a success only if it is one on every rank, and a
preemption on any rank stops them all. The trunk is a rank's part, so the
generator fit's features are collected on the training thread with the
sharded forward, every rank in step (``gen_fit_fn`` must then be a
:class:`repro_torch.train.generator_fit.GeneratorFit`, whose ``features``
does that); the fit thread gets them with the full embedding and head (gathered there
too) and issues no collective, so the fitted generator is bit-equal on
every rank. A checkpoint (and a ``gensnap``) holds the full arrays, as a
one-rank run's, written leaf by leaf: every rank joins the gather of one
leaf, rank 0 writes it and drops it, and all wait at the end; a restore
reads one full leaf at a time on every rank and cuts its part
(``parallel.sharding.StateLayout``). No rank holds the whole trunk.
``model_cfg`` (the model's config) gives the placement.
"""
from __future__ import annotations

import dataclasses
import functools
import operator
import signal
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree_util
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.genfit.refresh import (AsyncRefresher, drop_snapshot,
                                        latest_snapshot_step, load_snapshot,
                                        refresh_on_snr, save_snapshot,
                                        snapshot_path_exists, swap_event)
from repro_torch.obs import NULL_REGISTRY, JsonlExporter, ProfileWindow, Registry
from repro_torch.obs.trace import span
from repro_torch.optim import head_state_bytes
from repro_torch.parallel import sharding
from repro_torch.resilience import faults
from repro_torch.train.state import TrainState, snr_reset_pair
from repro_torch.train.step import publish_step_metrics


def _fit_with_retries(fit_fn, state, retries: int, backoff_s: float):
    """Blocking-fit twin of the AsyncRefresher worker's retry policy."""
    for attempt in range(retries + 1):
        try:
            faults.fire("genfit/fit")
            return fit_fn(state)
        except Exception:
            if attempt >= retries:
                raise
            time.sleep(backoff_s * (2 ** attempt))


def _clone(t):
    return t.clone() if isinstance(t, torch.Tensor) else t


def _fit_snapshot(state: TrainState) -> TrainState:
    """Clone the leaves a background generator fit reads.

    The training step writes the parameters in place, so a background fit
    still reading them would race. One copy of the fit's inputs per
    refresh submit (rare) keeps every step in place. ``gen_fit_fn``
    receives only (params, head_state, gen_fit_step) derived data, so only
    those leaves are copied. The clones are launched on the calling (the
    training) thread's stream before the fit thread starts; the fit thread
    launches on the same stream, so it reads them after they are written.
    """
    return state._replace(params=tree_util.tree_map(_clone, state.params),
                          head_state=tree_util.tree_map(_clone, state.head_state))


def _fit_call(state: TrainState, gen_fit_fn, mesh=None, snapshot: bool = True):
    """The fit of ``state`` as a call of no arguments, its inputs taken now,
    on the training thread. Without a mesh the fit reads
    :func:`_fit_snapshot` of ``state``, or ``state`` itself where nothing
    writes it while the fit runs (``snapshot=False``: a blocking fit, or a
    ``gensnap`` read from disk). Under ``mesh`` the trunk is a rank's part:
    the features are collected here with the sharded forward (a
    collective), and the fit gets them with the full embedding and head
    (gathered) and a copy of the head state, so it reads no trunk and
    issues no collective."""
    if mesh is None:
        return functools.partial(gen_fit_fn, _fit_snapshot(state) if snapshot else state)
    feats = gen_fit_fn.features(state.params, mesh)
    rows = sharding.gather_train_state({k: state.params[k] for k in ("embed", "head")}, mesh)
    return functools.partial(gen_fit_fn, state._replace(
        params=rows, head_state=tree_util.tree_map(_clone, state.head_state)), features=feats)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The sampling generator of step ``step``: seeded from (seed, step)
    alone, so a restart replays the exact stream."""
    ss = np.random.SeedSequence([int(seed), int(step)])
    return torch.Generator(device=device).manual_seed(
        int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1
    gen_warmup_steps: int = 0       # fit generator after this many steps
    gen_refresh_steps: int = 0      # 0 = never refresh after warmup
    gen_async: bool = False         # fit in a background thread
    gen_swap_delay: int = 0         # steps between submit and swap (async)
    # "period": refresh every gen_refresh_steps (the fields above).
    # "snr": refresh when the online gradient-SNR proxy (TrainState.
    # snr_ewma) degrades below snr_threshold x the
    # post-install reference; gen_refresh_steps is ignored after warmup.
    gen_refresh_mode: str = "period"
    snr_threshold: float = 0.85     # trigger at ewma < threshold * ref
    snr_patience: int = 8           # min steps after install before trigger
    # -- observability (repro_torch.obs) --
    metrics_jsonl: Optional[str] = None   # per-step JSONL event log path
    metrics_interval: int = 1       # emit a "step" event every N steps
    profile_dir: Optional[str] = None     # torch.profiler capture dir
    profile_steps: int = 5          # steady-state steps in the capture
    # -- resilience --
    # "skip": a non-finite step is dropped (requires the step's
    # skip_nonfinite guard for the state to survive it) and counted;
    # after max_consecutive_nonfinite skips in a row — or immediately,
    # when the step has no in-graph guard and the state is already
    # poisoned — the loop rolls back to the newest verifiable
    # checkpoint and replays. "raise" restores the legacy
    # FloatingPointError crash.
    nonfinite_policy: str = "skip"
    max_consecutive_nonfinite: int = 3
    max_rollbacks: int = 2          # rollback-restores before giving up
    gen_fit_retries: int = 2        # transient-failure retries per fit
    gen_fit_backoff_s: float = 0.05  # exponential backoff base
    gen_fit_timeout_s: Optional[float] = None  # hang watchdog (None = off)

    def gen_due(self, step: int) -> bool:
        return (step == self.gen_warmup_steps
                or bool(self.gen_refresh_steps
                        and step > self.gen_warmup_steps
                        and (step - self.gen_warmup_steps)
                        % self.gen_refresh_steps == 0))

    def last_submit_before(self, step: int) -> Optional[int]:
        """Latest refresh-submit step < ``step`` (None if none yet)."""
        if step <= self.gen_warmup_steps:
            return None
        if not self.gen_refresh_steps:
            return self.gen_warmup_steps
        k = (step - 1 - self.gen_warmup_steps) // self.gen_refresh_steps
        return self.gen_warmup_steps + k * self.gen_refresh_steps


class StragglerMonitor:
    """EWMA step-time tracker; flags outlier steps (straggler proxy)."""

    def __init__(self, factor: float, alpha: float):
        self.factor, self.alpha = factor, alpha
        self.ewma: Optional[float] = None
        self.flagged = 0
        self.history: List[float] = []

    def observe(self, dt: float) -> bool:
        self.history.append(dt)
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.flagged += 1
            # Do not fold outliers into the EWMA — keeps the baseline clean.
            return True
        self.ewma = dt if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * dt)
        return False


class Preemption:
    """SIGTERM-or-callback preemption flag (GCE/Borg-style eviction)."""

    def __init__(self, install_signal: bool = False):
        self._flag = False
        if install_signal:
            signal.signal(signal.SIGTERM, self._handler)

    def _handler(self, *_):
        self._flag = True

    def trigger(self):
        self._flag = True

    @property
    def requested(self) -> bool:
        return self._flag


def run_loop(state: TrainState, train_step: Callable, batch_fn: Callable,
             cfg: LoopConfig, seed: int,
             preemption: Optional[Preemption] = None,
             gen_fit_fn: Optional[Callable[[TrainState], Any]] = None,
             on_step: Optional[Callable[[int, Dict], None]] = None,
             registry: Optional[Registry] = None, mesh=None, model_cfg=None):
    """Run (or resume) training. Returns (state, history dict).

    ``batch_fn(step) -> batch`` must be deterministic in step.
    ``train_step(state, batch, generator)`` gets :func:`step_generator` of
    (``seed``, step). ``gen_fit_fn(state) -> LMHeadState`` refits the
    adversarial generator.

    Observability (repro_torch.obs): pass a ``registry`` to
    collect the documented ``train/*`` / ``snr/*`` / ``genfit/*``
    metrics; with ``cfg.metrics_jsonl`` set an own registry is created
    and every lifecycle event plus a per-``metrics_interval`` step
    sample is appended to the JSONL log. With neither, the loop runs
    against the shared null registry — the zero-overhead default.
    ``history`` keeps the reference's keys (loss/step/step_times/gen_*);
    ``step_times`` holds steady-state steps only, the first executed step
    of the process (kernel builds and allocator warm-up) lands in
    ``history["compile_time_s"]`` instead.

    ``mesh``: ``state`` is this rank's, ``batch_fn`` gives the global
    batches, ``train_step`` was built with the mesh and ``model_cfg`` is
    the model's config (module docstring).
    """
    preemption = preemption or Preemption()
    device = state.snr_ewma.device
    if mesh is not None:
        import torch.distributed as dist
        from repro_torch.parallel import collectives
        if model_cfg is None:
            raise ValueError("run_loop(mesh=) needs model_cfg, the placement's config")
        from repro_torch.train.generator_fit import GeneratorFit
        if gen_fit_fn is not None and not isinstance(gen_fit_fn, GeneratorFit):
            raise TypeError("under a mesh the generator fit's features are collected on "
                            "the training thread: gen_fit_fn must be a "
                            "train.generator_fit.GeneratorFit")
        lead = dist.get_rank() == 0

    def layout(st: TrainState):
        """How a checkpoint's full leaves are cut to this rank's ``st``."""
        return None if mesh is None else sharding.StateLayout(st.as_pytree(), mesh, model_cfg)

    def agreed(ok: bool) -> bool:
        return ok if mesh is None else collectives.agree(ok, device)

    def save(save_fn, directory, step, st, **kw):
        """Write the full state: under a mesh leaf by leaf, each gathered
        by every rank and written by rank 0; all ranks wait for the
        write."""
        tree = st.as_pytree()
        if mesh is None:
            save_fn(directory, step, tree, **kw)
            return
        leaves = sharding.iter_gathered_leaves(tree, mesh, model_cfg)
        if lead:
            save_fn(directory, step, tree, leaves=leaves, **kw)
        else:
            for _ in leaves:
                pass
        dist.barrier()

    monitor = StragglerMonitor(cfg.straggler_factor, cfg.ewma_alpha)
    if registry is None:
        registry = (Registry() if (cfg.metrics_jsonl or cfg.profile_dir)
                    else NULL_REGISTRY)
    if cfg.profile_dir:
        registry.annotate = True    # host spans show up on the trace
    exporter = (JsonlExporter(cfg.metrics_jsonl) if cfg.metrics_jsonl
                else None)
    emit = exporter.emit if exporter is not None else (lambda ev: None)
    profiler = ProfileWindow(cfg.profile_dir, cfg.profile_steps)
    # history is the compatibility view (keys appear only when the
    # corresponding event happened, as before); the registry is the
    # primary record.
    history: Dict[str, Any] = {"loss": [], "step": [], "step_times": []}
    if cfg.gen_refresh_mode not in ("period", "snr"):
        raise ValueError(f"unknown gen_refresh_mode "
                         f"{cfg.gen_refresh_mode!r} (period|snr)")
    snr_mode = cfg.gen_refresh_mode == "snr"
    if snr_mode and cfg.gen_async and cfg.gen_swap_delay > 0:
        if cfg.snr_patience <= cfg.gen_swap_delay:
            raise ValueError(
                "snr_patience must exceed gen_swap_delay: the trigger "
                "must stay quiet until the in-flight fit has been "
                "installed and its reference armed")
    if not snr_mode and cfg.gen_async and cfg.gen_refresh_steps:
        if cfg.gen_swap_delay >= cfg.gen_refresh_steps:
            raise ValueError(
                "gen_swap_delay must be < gen_refresh_steps (one refresh "
                "in flight at a time)")

    # ---- auto-resume ----------------------------------------------------
    start_step = int(state.step)
    if cfg.checkpoint_dir:
        ck = latest_step(cfg.checkpoint_dir)
        if ck is not None and ck > start_step:
            restored, _ = restore_checkpoint(cfg.checkpoint_dir, state.as_pytree(), step=ck,
                                             layout=layout(state))
            state = TrainState(**restored)
            start_step = int(state.step)

    # ---- re-establish an async refresh that was in flight ---------------
    use_async = (gen_fit_fn is not None and cfg.gen_async
                 and cfg.gen_swap_delay > 0)

    def establish_refresh(state: TrainState, start_step: int):
        """(Re)build the refresher + pending swap for a run (re)starting
        at ``start_step``. Called at startup and again after a
        rollback-restore — a rollback is a resume that never left the
        process, so it replays the same in-flight-fit recovery."""
        if not use_async:
            return None, None
        refresher = AsyncRefresher(
            operator.call, retries=cfg.gen_fit_retries,
            backoff_s=cfg.gen_fit_backoff_s,
            timeout_s=cfg.gen_fit_timeout_s)
        if snr_mode:
            # SNR-triggered submits are data-dependent, so the submit step
            # cannot be recomputed from the config — recover it from the
            # gensnap artifact the submit persisted. In flight iff the
            # snapshot postdates the installed generator and the resume
            # lands inside its (submit, swap] window.
            s_sub = (latest_snapshot_step(cfg.checkpoint_dir)
                     if cfg.checkpoint_dir else None)
            if s_sub is not None:
                fit_host = int(state.gen_fit_step)
                if not (s_sub > fit_host and s_sub < start_step):
                    s_sub = None
        else:
            s_sub = cfg.last_submit_before(start_step)
        if (s_sub is not None
                and start_step <= s_sub + cfg.gen_swap_delay
                and s_sub + cfg.gen_swap_delay < cfg.total_steps):
            # Resumed inside a (submit, swap] window: replay the fit from
            # the persisted submit-time snapshot. The fit is deterministic
            # in (state, config), so the swap installs bit-identical
            # parameters at the recorded step.
            if (cfg.checkpoint_dir
                    and snapshot_path_exists(cfg.checkpoint_dir, s_sub)):
                snap = load_snapshot(cfg.checkpoint_dir, s_sub, state.as_pytree(),
                                     layout(state))
                fit = _fit_call(TrainState(**snap), gen_fit_fn, mesh,
                                snapshot=False)   # a disk copy: not aliased
            else:
                fit = _fit_call(state, gen_fit_fn, mesh)
            refresher.submit(fit, s_sub)
            registry.counter("genfit/submits").inc()
            emit({"event": "gen_submit", "step": s_sub, "resumed": True})
            return refresher, s_sub + cfg.gen_swap_delay
        return refresher, None

    refresher, pending_swap = establish_refresh(state, start_step)

    # Head param + optimizer-state footprint (DESIGN.md §11): a static
    # function of shapes/dtypes, computed once and republished as a gauge
    # with every step sample.
    try:
        hs_bytes: Optional[int] = head_state_bytes(state.params,
                                                   state.opt_state)
    except Exception:
        hs_bytes = None     # exotic state trees: skip the gauge, not the run

    # Consumed gensnap artifacts are dropped only once a *durable*
    # checkpoint from beyond their swap step exists: a resume always loads
    # the latest checkpoint, and any checkpoint labeled <= swap_step
    # re-enters the replay window and needs the snapshot (a hard kill
    # right after the swap must not lose the replay source).
    snaps_to_drop: List[tuple] = []

    def maybe_checkpoint(step, force=False):
        if not cfg.checkpoint_dir:
            return
        if force or (cfg.checkpoint_every
                     and step % cfg.checkpoint_every == 0 and step > 0):
            save(save_checkpoint, cfg.checkpoint_dir, step, state,
                 keep=cfg.keep_checkpoints)
            for s_sub, s_swap in list(snaps_to_drop):
                if step > s_swap:
                    if mesh is None or lead:
                        drop_snapshot(cfg.checkpoint_dir, s_sub)
                    snaps_to_drop.remove((s_sub, s_swap))

    # Resilience counters (DESIGN.md §13): consecutive non-finite steps
    # and rollback-restores consumed so far.
    nonfinite_streak = 0
    rollbacks = 0
    first_executed = True

    step = start_step
    while step < cfg.total_steps:
        # -- generator warmup / refresh (the paper's Step 1) --
        if gen_fit_fn is not None:
            if pending_swap is not None and step == pending_swap:
                # Recorded swap point: install the background fit (blocks
                # only if the fit is still running — by construction the
                # step is config-determined, never timing-determined).
                old_fit = int(state.gen_fit_step)
                s_sub_val = refresher.submit_step
                err = None
                try:
                    head, s_sub = refresher.result()
                except Exception as e:
                    err = e
                if not agreed(err is None) and err is None:
                    err = RuntimeError("the generator fit failed on another rank")
                if err is not None:
                    # Degradation ladder: the fit failed (retries
                    # exhausted) or hung (watchdog). Keep serving the
                    # stale generator; clearing pending_swap drops the
                    # busy latch, so the SNR trigger — whose EWMA is
                    # still degraded against the OLD install's reference
                    # — re-arms and fires a fresh submit on a later
                    # step instead of the run dying at the swap.
                    registry.counter("genfit/refresh_failed").inc()
                    history.setdefault("gen_refresh_failed_steps",
                                       []).append(step)
                    emit({"event": "gen_refresh_failed", "step": step,
                          "submit_step": s_sub_val, "reason": repr(err)})
                    if cfg.checkpoint_dir:
                        snaps_to_drop.append((s_sub_val, step))
                    pending_swap = None
                else:
                    # Fresh generator: restart the SNR proxy EWMA and
                    # disarm the reference (re-armed snr_patience steps
                    # after the install).
                    ewma0, ref0 = snr_reset_pair(state.snr_ewma.device)
                    state = state._replace(
                        head_state=head, gen_fit_step=int(s_sub),
                        snr_ewma=ewma0, snr_ref=ref0)
                    pending_swap = None
                    history.setdefault("gen_swap_steps", []).append(step)
                    emit(swap_event(step, old_fit, s_sub,
                                    refresher.last_fit_seconds, registry))
                    if cfg.checkpoint_dir:
                        snaps_to_drop.append((s_sub, step))
            if snr_mode:
                # Warmup fit is scheduled; every later refresh is
                # triggered by the online SNR proxy degrading (the state
                # it reads is checkpointed, so resume replays the same
                # trigger steps).
                due = step == cfg.gen_warmup_steps
                if not due:
                    fit_host = int(state.gen_fit_step)
                    install_est = (fit_host + cfg.gen_swap_delay
                                   if use_async and fit_host >= 0
                                   else fit_host)
                    fired = refresh_on_snr(
                        step, install_est,
                        float(state.snr_ewma), float(state.snr_ref),
                        cfg.snr_threshold, cfg.snr_patience)
                    busy = (pending_swap is not None
                            or (refresher is not None
                                and refresher.in_flight))
                    if fired and busy:
                        # One refresh in flight at a time: the trigger
                        # fired but submission declines. Counted per
                        # declined step — a growing counter here means
                        # the EWMA stayed degraded through a whole
                        # submit→swap window (tune gen_swap_delay).
                        registry.counter("genfit/refresh_skipped").inc()
                    elif fired:
                        due = True
                        history.setdefault("snr_trigger_steps", []).append(step)
                        emit({"event": "snr_trigger", "step": step})
            else:
                due = cfg.gen_due(step)
            if due:
                # An async fit whose swap step cannot land inside the run
                # would never be installed — fit blocking instead (still a
                # pure function of the config, so resume stays exact).
                if use_async and step + cfg.gen_swap_delay < cfg.total_steps:
                    if refresher.in_flight:
                        raise RuntimeError(
                            f"generator refresh submitted at step {step} "
                            f"while one is in flight")
                    if cfg.checkpoint_dir:
                        save(save_snapshot, cfg.checkpoint_dir, step, state)
                    refresher.submit(_fit_call(state, gen_fit_fn, mesh), step)
                    pending_swap = step + cfg.gen_swap_delay
                    history.setdefault("gen_submit_steps", []).append(step)
                    registry.counter("genfit/submits").inc()
                    emit({"event": "gen_submit", "step": step})
                else:
                    old_fit = int(state.gen_fit_step)
                    t_fit = time.perf_counter()
                    err = None
                    try:
                        new_head = _fit_with_retries(
                            operator.call, _fit_call(state, gen_fit_fn, mesh, snapshot=False),
                            cfg.gen_fit_retries, cfg.gen_fit_backoff_s)
                    except Exception as e:
                        err = e
                    if not agreed(err is None) and err is None:
                        err = RuntimeError("the generator fit failed on another rank")
                    if err is not None:
                        # Same ladder as the async swap: keep the stale
                        # generator, record the failure, train on.
                        registry.counter("genfit/refresh_failed").inc()
                        history.setdefault("gen_refresh_failed_steps",
                                           []).append(step)
                        emit({"event": "gen_refresh_failed", "step": step,
                              "submit_step": step, "reason": repr(err)})
                    else:
                        fit_s = time.perf_counter() - t_fit
                        ewma0, ref0 = snr_reset_pair(state.snr_ewma.device)
                        state = state._replace(
                            head_state=new_head, gen_fit_step=int(step),
                            snr_ewma=ewma0, snr_ref=ref0)
                        history.setdefault("gen_swap_steps",
                                           []).append(step)
                        registry.counter("genfit/submits").inc()
                        emit(swap_event(step, old_fit, step, fit_s,
                                        registry))

        # The first executed step of THIS process pays the kernels' builds
        # and the allocator's warm-up — a different quantity from the
        # steady-state step time, recorded
        # as compile_time_s and excluded from step_times, the straggler
        # EWMA, and the train/step_time_s histogram (benchmarks no
        # longer hand-trim step 0). Profiling likewise starts only once
        # the warm-up is out of the way.
        is_compile = first_executed
        first_executed = False
        if not is_compile:
            profiler.tick(step)
        t0 = time.perf_counter()
        with span("train/phase/data", registry):
            batch = batch_fn(step)
        # Site "train/batch": a corrupt action NaN-poisons the batch so
        # the non-finite path is exercised end to end *inside* the step,
        # not via a synthetic host-side flag.
        batch = faults.inject("train/batch", batch)
        # Step-indexed generator (not one sequential stream): restart from
        # a checkpoint replays the exact draws — bit-exact recovery.
        gen = step_generator(seed, step, device)
        with span("train/phase/step", registry):
            state, metrics = train_step(state, batch, gen)
            if device.type == "cuda":
                torch.cuda.synchronize(device)  # the optimizer's writes too
            loss = float(metrics["loss"])
        dt = time.perf_counter() - t0

        # "nonfinite" is the step's skip guard report (train/step.py
        # skip_nonfinite): when present and set, the step wrote nothing
        # and the host sees a clean skip.
        # A non-finite loss WITHOUT the guard means the optimizer
        # applied poisoned gradients — only rollback can recover.
        guarded = "nonfinite" in metrics
        skipped = guarded and float(metrics["nonfinite"]) > 0
        bad = skipped or not np.isfinite(loss)
        if bad and cfg.nonfinite_policy != "skip":
            raise FloatingPointError(f"non-finite loss at step {step}")
        slow = False
        if is_compile:
            history["compile_time_s"] = dt
            registry.gauge("train/compile_time_s").set(dt)
            emit({"event": "compile", "step": step, "compile_time_s": dt})
        else:
            slow = monitor.observe(dt)
            history["step_times"].append(dt)
            registry.histogram("train/step_time_s").observe(dt)
            if slow:
                registry.counter("train/stragglers").inc()
        history["loss"].append(loss)
        history["step"].append(step)

        sample_due = (exporter is not None and not is_compile
                      and step % max(cfg.metrics_interval, 1) == 0)
        if on_step is not None or registry.enabled or sample_due:
            # The (tiny, already-computed) metrics read once as floats,
            # shared by the callback, the gauges, and the JSONL sample.
            host_m = {k: float(v) for k, v in metrics.items()}
            snr_ref = (float(state.snr_ref)
                       if "snr_ewma" in host_m else None)
            publish_step_metrics(registry, host_m, snr_ref=snr_ref,
                                 head_state_bytes=hs_bytes)
            if sample_due:
                ev = {"event": "step", "step": step, "loss": loss,
                      "step_time_s": dt, "straggler": slow}
                for k in ("snr_proxy", "snr_ewma", "grad_norm"):
                    if k in host_m:
                        ev[k] = host_m[k]
                if snr_ref is not None:
                    ev["snr_ref"] = snr_ref
                emit(ev)
            if on_step is not None:
                on_step(step, {**host_m, "step_time": dt,
                               "straggler": slow})

        if bad:
            nonfinite_streak += 1
            registry.counter("train/nonfinite_skipped").inc()
            history.setdefault("nonfinite_steps", []).append(step)
            emit({"event": "nonfinite_skip", "step": step,
                  "streak": nonfinite_streak})
            if not guarded or nonfinite_streak >= cfg.max_consecutive_nonfinite:
                # Rollback-restore: rewind to the newest verifiable
                # checkpoint and replay. The data/rng streams are
                # step-indexed, so the replay is deterministic; a
                # persistent cause re-fires and the rollback budget
                # converts it into the legacy crash.
                rollbacks += 1
                ck = (latest_step(cfg.checkpoint_dir)
                      if cfg.checkpoint_dir else None)
                if ck is None or rollbacks > cfg.max_rollbacks:
                    raise FloatingPointError(
                        f"non-finite loss at step {step} ("
                        + ("no verifiable checkpoint to roll back to"
                           if ck is None else
                           f"rollback budget {cfg.max_rollbacks} "
                           f"exhausted") + ")")
                restored, _ = restore_checkpoint(
                    cfg.checkpoint_dir, state.as_pytree(), step=ck, layout=layout(state))
                state = TrainState(**restored)
                registry.counter("train/rollbacks").inc()
                history.setdefault("rollback_steps", []).append([step, ck])
                emit({"event": "rollback_restore", "step": step,
                      "restored_step": ck})
                nonfinite_streak = 0
                refresher, pending_swap = establish_refresh(state, ck)
                step = ck
                continue
            # Clean skip (the guard kept the state): fall through —
            # checkpointing and preemption still see a valid state.
        else:
            nonfinite_streak = 0

        if snr_mode and gen_fit_fn is not None:
            # Arm the reference snr_patience steps after the install:
            # freeze the EWMA as the "healthy" level the trigger compares
            # against. A running max would false-trigger on a fresh
            # generator — the proxy naturally decays from its 1/2 optimum
            # as the discriminator sharpens — so the reference is a fixed
            # early-window snapshot instead. Runs before maybe_checkpoint
            # so the armed value is durable and resume replays it.
            fit_host = int(state.gen_fit_step)
            if fit_host >= 0:
                install_est = (fit_host + cfg.gen_swap_delay
                               if use_async else fit_host)
                if (float(state.snr_ref) < 0
                        and float(state.snr_ewma) >= 0
                        and step - install_est >= cfg.snr_patience):
                    state = state._replace(snr_ref=state.snr_ewma.clone())

        maybe_checkpoint(step + 1)
        if not agreed(not preemption.requested):
            maybe_checkpoint(step + 1, force=True)
            history["preempted_at"] = step + 1
            break
        step += 1

    history["stragglers"] = monitor.flagged
    profiler.stop()
    if registry.enabled:
        history["metrics"] = registry.snapshot()
    if exporter is not None:
        exporter.emit({"event": "summary", "metrics": registry.snapshot()})
        exporter.close()
    return state, history
