"""Preemption-safe training (counterpart of ``madtp_tpu/utils/preempt.py``).
:class:`PreemptionGuard` sets a flag on the first SIGTERM or SIGUSR1
(calling any handler installed before it); the drivers poll
:meth:`~PreemptionGuard.should_stop` after each train step, leave the epoch,
save their resume checkpoint and exit, and ``--resume`` restarts the
interrupted epoch.

Under several processes every rank must leave the step loop on the same
batch, or the others would wait in the next step's collectives: the flag is
OR-reduced over the ranks every ``SYNC_EVERY`` polls and at
:meth:`~PreemptionGuard.sync_now`, and only that decision stops the loop.
The loaders' shards are of equal length, so every rank polls as often."""

from __future__ import annotations

import signal
import threading

import numpy as np

from madtp_tpu_torch.parallel import dist

SYNC_EVERY = 8  # polls between the ranks' OR-reduces of the flag

class PreemptionGuard:
    """Install with ``PreemptionGuard()``; poll ``should_stop()`` per batch.
    ``triggered`` is True once a stop has been decided."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1)):
        self._flag = False
        self._decided = False
        self._calls = 0
        self._lock = threading.Lock()
        self._prev = {}
        if threading.current_thread() is threading.main_thread():
            for sig in signals:
                self._prev[sig] = signal.signal(sig, self._on_signal)

    def _on_signal(self, signum, frame):
        self._flag = True
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def request_stop(self):
        """Stop at the next poll (a test hook, or a wall-clock budget)."""
        self._flag = True

    def _decide(self) -> bool:
        if dist.process_count() <= 1:
            self._decided = self._flag
        else:
            flags = dist.host_allgather(np.asarray([1 if self._flag else 0], np.int32))
            self._decided = bool(flags.any())
        return self._decided

    def should_stop(self) -> bool:
        """The batch-boundary poll: immediate with one process; under several
        every rank calls it at the same batch, and the flag is OR-reduced
        every ``SYNC_EVERY`` calls."""
        if self._decided:
            return True
        if dist.process_count() > 1:
            with self._lock:
                self._calls += 1
                if self._calls % SYNC_EVERY:
                    return False
        return self._decide()

    def sync_now(self) -> bool:
        """The epoch-boundary check (a collective under several processes): a
        signal that came after the last poll still stops the run before the
        next epoch."""
        if self._decided:
            return True
        return self._decide()

    @property
    def triggered(self) -> bool:
        return self._decided
