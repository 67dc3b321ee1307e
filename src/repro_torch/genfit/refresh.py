"""Non-blocking generator refresh, as ``repro.genfit.refresh``.

The training loop must not stall every accelerator for the duration of a
generator fit (the paper's "Step 1"), but it also must stay *bit-exact
recoverable*: a run that checkpoints and resumes mid-refresh has to end up
with exactly the parameters of an uninterrupted run. The protocol:

1. **Submit** at a schedule-determined step ``s``: the loop clones the
   train state's fit inputs, persists them as a ``gensnap_<s>`` artifact next
   to the checkpoints, and hands the fit to a background thread. Training
   continues on the stale generator.
2. **Swap** at the *recorded* step ``s + gen_swap_delay``: the loop blocks
   (usually a no-op — the fit finished long ago) and installs the new head
   state. The swap step is a pure function of the config, never of thread
   timing, so data/rng streams are unaffected by how long the fit took.
3. **Resume**: if a restart lands inside the (submit, swap] window, the
   loop reloads the ``gensnap`` artifact and re-runs the fit — the fit
   functions in :mod:`repro_torch.genfit` are deterministic in (state, config),
   so the replayed swap installs bit-identical parameters at the same
   step.

``AsyncRefresher`` is the small thread harness behind step 1/2; the
orchestration lives in :func:`repro_torch.train.loop.run_loop`.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional, Tuple

from repro_torch.obs import NULL_REGISTRY
from repro_torch.resilience import faults

SNAP_PREFIX = "gensnap_"


class RefreshTimeout(TimeoutError):
    """The watchdog gave up on a hung background fit."""


class _Job:
    """One submission's private result slots. The worker writes only to
    its own job, so a hung thread abandoned by the watchdog can never
    clobber a *later* submission's state when it finally wakes up."""

    __slots__ = ("result", "error", "done", "step", "thread", "wall_s")

    def __init__(self, step: int):
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.done = False
        self.step = step
        self.thread: Optional[threading.Thread] = None
        self.wall_s: Optional[float] = None


class AsyncRefresher:
    """One-in-flight background fit with retries, a hang watchdog, and
    exception propagation (the generator fit's degradation ladder).

    ``submit(state, step)`` starts ``fit_fn(state)`` on a worker thread;
    the worker retries transient failures ``retries`` times with
    exponential backoff (``backoff_s * 2**attempt``) before recording the
    last error. ``result()`` joins — bounded by ``timeout_s`` when set —
    and returns, or raises: the worker's final exception for a failed
    fit, :class:`RefreshTimeout` for a hung one (the stuck daemon thread
    is abandoned, not joined; per-job result slots keep it harmless).
    The *caller* decides what failure means — the training loop keeps
    the stale generator and re-arms the SNR trigger rather than dying.

    The port's training step updates its tensors in place, so the caller
    submits a snapshot that owns its storage (``train.loop._fit_snapshot``
    clones what the fit reads, on the training thread's stream, before the
    submit). The fit thread launches on the same stream, so its reads are
    ordered after the clone. PyTorch releases the GIL inside its operators,
    so training steps overlap the fit's host work.
    """

    def __init__(self, fit_fn: Callable[[Any], Any], retries: int = 0,
                 backoff_s: float = 0.05,
                 timeout_s: Optional[float] = None):
        self._fit_fn = fit_fn
        self._retries = retries
        self._backoff_s = backoff_s
        self._timeout_s = timeout_s
        self._job: Optional[_Job] = None
        self._last_step: Optional[int] = None
        # Wall time of the most recently *completed* fit (None until one
        # finishes) — the `fit_wall_s` field of the gen_swap event.
        self.last_fit_seconds: Optional[float] = None

    @property
    def in_flight(self) -> bool:
        return self._job is not None

    @property
    def submit_step(self) -> Optional[int]:
        # Survives result()/failure so the failure handler can name the
        # submission it is cleaning up after.
        return self._job.step if self._job is not None else self._last_step

    def submit(self, state, step: int) -> None:
        assert self._job is None, "refresh already in flight"
        job = _Job(step)

        def work():
            t0 = time.perf_counter()
            for attempt in range(self._retries + 1):
                try:
                    # Site "genfit/fit": one invocation per *attempt*, so
                    # a scheduled transient raise is absorbed by a retry.
                    faults.fire("genfit/fit")
                    job.result = self._fit_fn(state)
                    job.wall_s = time.perf_counter() - t0
                    self.last_fit_seconds = job.wall_s
                    job.error = None
                    break
                except BaseException as e:    # surfaced via result()
                    job.error = e
                    if attempt < self._retries:
                        time.sleep(self._backoff_s * (2 ** attempt))
            job.done = True

        job.thread = threading.Thread(
            target=work, name=f"gen-refresh@{step}", daemon=True)
        self._job = job
        self._last_step = step
        job.thread.start()

    def ready(self) -> bool:
        return self._job is not None and self._job.done

    def result(self) -> Tuple[Any, int]:
        """Join the worker and return (head_state, submit_step)."""
        job = self._job
        assert job is not None, "no refresh in flight"
        job.thread.join(self._timeout_s)
        if not job.done and job.thread.is_alive():
            # Hung fit: abandon the daemon thread (its writes land in
            # its own job, now unreachable) and report the watchdog.
            self._job = None
            raise RefreshTimeout(
                f"generator fit submitted at step {job.step} exceeded "
                f"watchdog timeout {self._timeout_s}s")
        self._job = None
        if job.error is not None:
            raise job.error
        return job.result, job.step


def refresh_on_snr(step: int, fit_step: int, snr_ewma: float,
                   snr_ref: float, threshold: float, patience: int) -> bool:
    """SNR-driven refresh trigger.

    Fires when the online signal-mass EWMA has degraded below
    ``threshold`` x the post-install reference level. ``fit_step`` is the
    *install* step of the current generator (submit step + swap delay for
    async refreshes); ``patience`` steps must elapse after the install
    before the trigger can fire, which also gives the reference time to be
    armed (the loop freezes ``snr_ref`` = EWMA ``patience`` steps after
    install). Both ``snr_ewma`` and ``snr_ref`` are < 0 while unset, so
    the trigger is inert until a generator is installed AND the reference
    is armed — a fresh generator never fires.
    """
    return (fit_step >= 0 and snr_ref > 0 and snr_ewma >= 0
            and step - fit_step >= patience
            and snr_ewma < threshold * snr_ref)


def swap_event(step: int, old_fit_step: int, new_fit_step: int,
               fit_wall_s: Optional[float], registry=None) -> dict:
    """Structured record of a generator swap (emitted on EVERY install —
    warmup, periodic, SNR-triggered, blocking or async).

    ``old_fit_step`` is the submit step of the generator being replaced
    (-1 for the warmup install), ``new_fit_step`` the submit step of the
    incoming one, ``fit_wall_s`` the background/blocking fit's wall time
    (None when a replayed resume raced past the measurement), and
    ``steps_stale_at_swap`` = step - new_fit_step: how many optimizer
    steps the discriminator advanced between the snapshot the fit saw
    and the install — the staleness the paper's alternating scheme
    tolerates, and the quantity to watch when tuning ``gen_swap_delay``.

    Also folds the swap into ``registry``: ``genfit/swaps`` counter,
    ``genfit/fit_wall_s`` and ``genfit/staleness_at_swap`` histograms.
    Returns the JSONL-ready ``gen_swap`` event dict.
    """
    reg = registry or NULL_REGISTRY
    stale = step - new_fit_step
    reg.counter("genfit/swaps").inc()
    if fit_wall_s is not None:
        reg.histogram("genfit/fit_wall_s").observe(fit_wall_s)
    reg.histogram("genfit/staleness_at_swap",
                  bounds=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                          1024]).observe(stale)
    return {"event": "gen_swap", "step": step,
            "old_fit_step": old_fit_step, "new_fit_step": new_fit_step,
            "fit_wall_s": fit_wall_s, "steps_stale_at_swap": stale}


def latest_snapshot_step(directory: str) -> Optional[int]:
    """Largest step with a complete ``gensnap`` artifact (None if none).

    SNR-triggered submits are data-dependent, not config-determined, so a
    resume cannot recompute the submit step the way the periodic schedule
    can (``LoopConfig.last_submit_before``) — it recovers it from the
    artifact that the submit persisted.
    """
    import os

    from repro_torch.checkpoint import MANIFEST
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if not name.startswith(SNAP_PREFIX):
            continue
        try:
            s = int(name[len(SNAP_PREFIX):])
        except ValueError:
            continue
        if os.path.exists(os.path.join(directory, name, MANIFEST)):
            steps.append(s)
    return max(steps) if steps else None


def snapshot_path_exists(directory: str, step: int) -> bool:
    import os

    from repro_torch.checkpoint import MANIFEST
    return os.path.exists(os.path.join(
        directory, f"{SNAP_PREFIX}{step:08d}", MANIFEST))


def save_snapshot(directory: str, step: int, pytree, leaves=None) -> str:
    """Persist the submit-time state under ``gensnap_<step>`` (atomic,
    ignored by checkpoint GC and the LATEST pointer); ``leaves`` as
    ``save_checkpoint`` takes them."""
    from repro_torch.checkpoint import save_checkpoint
    return save_checkpoint(directory, step, pytree, keep=0,
                           prefix=SNAP_PREFIX, update_latest=False, leaves=leaves)


def load_snapshot(directory: str, step: int, tree_like, layout=None):
    from repro_torch.checkpoint import restore_checkpoint
    state, _ = restore_checkpoint(directory, tree_like, step=step,
                                  prefix=SNAP_PREFIX, layout=layout)
    return state


def drop_snapshot(directory: str, step: int) -> None:
    """Remove a consumed ``gensnap`` artifact (post-swap cleanup)."""
    import os
    import shutil
    shutil.rmtree(os.path.join(directory, f"{SNAP_PREFIX}{step:08d}"),
                  ignore_errors=True)
