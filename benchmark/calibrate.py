"""The gather schedule's capacities from mask-mode kept counts, as the
reference works them out again: a frozen copy of
``madtp_tpu_torch/prune/calibrate.py:18-59`` (``calibrate_capacities``,
``fast_capacity_schedule``)."""

from __future__ import annotations

import numpy as np


def calibrate(kept, *, margin: int, multiple: int, mode: str = "ceil", max_tokens=10_000):
    """Per-layer capacity (CLS + patches + merge slot) from kept counts
    ``[n_batches, L]``: the most kept, less one, plus ``margin`` and 2,
    rounded up to ``multiple`` ("ceil") or to the nearest multiple, at least
    one ("nearest"); then made non-increasing."""
    kept = np.asarray(kept).reshape(-1, np.asarray(kept).shape[-1])
    caps = []
    for k in kept.max(axis=0):
        need = int(k) - 1 + margin + 2
        if mode == "nearest":
            cap = max(multiple, int(round(need / multiple)) * multiple)
        else:
            cap = -(-need // multiple) * multiple
        caps.append(min(cap, max_tokens))
    for i in range(1, len(caps)):
        caps[i] = min(caps[i], caps[i - 1])
    return tuple(caps)


def schedules(v_kept, t_kept, cap_mode: str):
    """The vision schedule (margin 16, multiples of 128 "nearest" or 64
    "ceil") and the text one (margin 4, ceil to 8; None without counts)."""
    cv = calibrate(v_kept, margin=16, multiple=128 if cap_mode == "nearest" else 64,
                   mode=cap_mode)
    ct = None if t_kept is None else calibrate(t_kept, margin=4, multiple=8)
    return cv, ct


# The temperature's bisection in every cell's set-up: geometric, over this
# range, in this many steps (a last step's width is about 0.7%).
BISECT_RANGE = (0.05, 60.0)
BISECT_STEPS = 10


def bisect_temperature(flops_at, target: float) -> float:
    """The temperature at which ``flops_at(t)``, the frozen FLOP count on the
    mask-mode kept counts at ``t``, reads ``target``.  More temperature
    prunes more, so the count falls as ``t`` grows."""
    lo, hi = BISECT_RANGE
    t = None
    for _ in range(BISECT_STEPS):
        t = (lo * hi) ** 0.5
        if flops_at(t) > target:
            lo = t
        else:
            hi = t
    return t
