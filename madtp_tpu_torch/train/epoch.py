"""The train epoch's host loop, shared by every task: a one-deep metric
lag, so the host never waits on the card for step ``i``'s losses before step
``i+1`` is dispatched, ``stop()`` polled after each step, and the stats as
the JAX drivers' ``MetricLogger`` averages them."""

from __future__ import annotations

from typing import Callable, Iterable


def run_epoch(batches: Iterable, run_step: Callable, temperature: float, *, lr: float = 0.0,
              print_fn=print, print_freq: int = 50, stop=None) -> dict:
    """``run_step(i, batch)`` dispatches batch ``i``'s step and returns its
    metrics (device scalars or floats), read back one step later.  A stopped
    epoch counts every batch it trained exactly once.  Returns the mean of
    ``temperature``, ``lr`` and each metric as ``"%.4f"`` strings, and
    ``batches_done`` (int)."""
    sums: dict = {}

    def record(metrics):
        vals = dict(temperature=float(temperature), lr=lr,
                    **{k: float(v) for k, v in metrics.items()})
        for k, v in vals.items():
            total, count = sums.get(k, (0.0, 0))
            sums[k] = (total + v, count + 1)

    pending = None
    batches_done = 0
    for i, batch in enumerate(batches):
        metrics = run_step(i, batch)
        if pending is not None:
            record(pending)
        pending = metrics
        batches_done += 1
        if print_freq and i % print_freq == 0:
            print_fn(f"Train: [{i}] T={temperature} lr={lr}")
        if stop is not None and stop():
            break
    if pending is not None:
        record(pending)
    stats = {k: f"{total / max(count, 1):.4f}" for k, (total, count) in sums.items()}
    stats["batches_done"] = batches_done
    return stats
