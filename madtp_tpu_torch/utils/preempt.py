"""Preemption-safe training, single process (counterpart of
``madtp_tpu/utils/preempt.py``).  :class:`PreemptionGuard` sets a flag on the
first SIGTERM or SIGUSR1 (calling any handler installed before it); the
drivers poll :meth:`should_stop` after each train step, leave the epoch,
save their resume checkpoint and exit, and ``--resume`` restarts the
interrupted epoch."""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Install with ``PreemptionGuard()``; poll ``should_stop()`` per batch.
    ``triggered`` is True once a stop has been decided."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1)):
        self._flag = False
        self._decided = False
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

    def should_stop(self) -> bool:
        """The batch-boundary poll."""
        self._decided = self._decided or self._flag
        return self._decided

    def sync_now(self) -> bool:
        """The epoch-boundary check: a signal that came after the last poll
        still stops the run before the next epoch."""
        self._decided = self._decided or self._flag
        return self._decided

    @property
    def triggered(self) -> bool:
        return self._decided
