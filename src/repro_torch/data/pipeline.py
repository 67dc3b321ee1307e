"""Host-sharded, prefetching data pipeline, a copy of ``repro.data.pipeline``
(numpy batches, bit-equal to the reference's for the same arguments).

Designed for the multi-host setting: each host computes its slice of the
global batch from (num_hosts, host_id) — no cross-host coordination, fully
deterministic from (seed, step), so checkpoint/restart only needs the step
counter (the loader itself is stateless). A small background-thread prefetch
queue overlaps host-side generation with device compute.

Failure semantics: the producer thread never dies
silently. An exception in ``make_batch`` is captured and re-raised in the
*consumer* at the next ``__iter__`` pull — the training loop sees the
real error instead of hanging forever on an empty queue. ``close()``
reports whether the producer actually exited: if the join times out, the
loader is marked ``failed`` and keeps the thread reference (a leaked
thread you can see beats one that silently vanished).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.resilience import faults


class ProducerError(RuntimeError):
    """The prefetch producer died; ``__cause__`` is the original error."""


class HostShardedLoader:
    """Wraps a `make_batch(step) -> np.ndarray...` function with host
    slicing + prefetch."""

    def __init__(self, make_global_batch: Callable[[int], dict],
                 global_batch: int, num_hosts: int = 1, host_id: int = 0,
                 prefetch: int = 2, start_step: int = 0):
        assert global_batch % num_hosts == 0, (global_batch, num_hosts)
        self._make = make_global_batch
        self._gb = global_batch
        self._hosts = num_hosts
        self._host = host_id
        self._step = start_step
        self._prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        # True when close() could not join the producer within its grace
        # period — the loader refuses to restart until recreated.
        self.failed = False

    # -- host slicing -----------------------------------------------------
    def _slice(self, batch: dict) -> dict:
        per = self._gb // self._hosts
        lo = self._host * per
        return {k: (v[lo:lo + per] if hasattr(v, "shape")
                    and v.shape and v.shape[0] == self._gb else v)
                for k, v in batch.items()}

    def _produce(self):
        step = self._step
        try:
            while not self._stop.is_set():
                faults.fire("data/produce")
                item = (step, self._slice(self._make(step)))
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1
        except BaseException as e:
            # Park the error, then unblock a consumer waiting on get():
            # the sentinel loses races against in-flight items but the
            # consumer re-checks _error on every pull.
            self._error = e
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            self._stop.set()
            raise ProducerError(
                f"prefetch producer died: {err!r}") from err

    # -- iteration --------------------------------------------------------
    def __iter__(self) -> Iterator[tuple]:
        if self._prefetch > 0:
            assert not self.failed, \
                "loader previously failed to shut down; recreate it"
            self._q = queue.Queue(maxsize=self._prefetch)
            self._stop.clear()
            self._error = None
            self._thread = threading.Thread(target=self._produce,
                                            daemon=True)
            self._thread.start()
            try:
                while True:
                    try:
                        # Timed get: if the death sentinel lost its race
                        # against a full queue, the next timeout notices
                        # the parked error instead of blocking forever.
                        item = self._q.get(timeout=0.5)
                    except queue.Empty:
                        self._raise_if_failed()
                        continue
                    if item is None:        # producer's death sentinel
                        self._raise_if_failed()
                        continue
                    # Batches produced before the failure still flow —
                    # the error surfaces once the queue runs dry, so a
                    # crash at step N never swallows steps < N.
                    yield item
            finally:
                self.close()
        else:
            step = self._step
            while True:
                faults.fire("data/produce")
                yield step, self._slice(self._make(step))
                step += 1

    def close(self):
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            if self._thread.is_alive():
                # Producer wedged past the grace period: keep the handle
                # and poison the loader instead of silently leaking.
                self.failed = True
            else:
                self._thread = None

    def seek(self, step: int):
        """Restart-safe: position the stream at `step` (post-restore)."""
        self.close()
        self._step = step


def lm_batch_fn(vocab_size: int, global_batch: int, seq_len: int,
                seed: int = 0, n_clusters: int = 64):
    """Deterministic (seed, step) -> {tokens, labels, mask} for LM training.

    Labels are next tokens; the last position is masked out.
    """
    from repro_torch.data.synthetic import zipf_token_stream

    def make(step: int) -> dict:
        # Stateless: re-derive the stream at `step` directly.
        rng = np.random.default_rng((seed, step))
        it = zipf_token_stream(vocab_size, global_batch, seq_len + 1,
                               seed=seed * 1_000_003 + step,
                               n_clusters=n_clusters)
        toks = next(it)
        del rng
        mask = np.ones((global_batch, seq_len), np.float32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(
            np.int32), "mask": mask}

    return make
