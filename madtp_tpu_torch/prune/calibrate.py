"""Capacity-schedule calibration for gather-mode DTP
(copy of ``madtp_tpu/prune/calibrate.py:18-58``): per-layer buffer sizes from
mask-mode kept counts, with a margin, rounded to a multiple; and the
``--fast_eval`` / ``--fast_train`` schedules of both towers
(``madtp_tpu/cli/common.py:234-276``), which the NLVR and retrieval tasks
share."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def calibrate_capacities(
    kept_counts: np.ndarray,  # [n_batches, L] kept patches (incl. merged)
    *,
    margin: int = 8,
    multiple: int = 32,
    max_tokens: int = 10_000,
    mode: str = "ceil",
) -> Tuple[int, ...]:
    """Per-layer buffer capacity (CLS + patches + merge slot).  ``"ceil"``
    rounds the need up to ``multiple`` (lossless); ``"nearest"`` rounds to the
    nearest multiple, never below one, and lets the excess overflow into the
    merge token.  The schedule is made non-increasing."""
    kept = np.asarray(kept_counts).reshape(-1, np.asarray(kept_counts).shape[-1])
    caps = []
    for k in kept.max(axis=0):
        need = int(k) - 1 + margin + 2
        if mode == "nearest":
            cap = max(multiple, int(round(need / multiple)) * multiple)
        else:
            cap = round_up(need, multiple)
        caps.append(min(cap, max_tokens))
    for i in range(1, len(caps)):
        caps[i] = min(caps[i], caps[i - 1])
    return tuple(caps)


def fast_capacity_schedule(vk, tk, cap_mode: str, *, margin_v: int = 16,
                           margin_t: int = 4):
    """Capacity schedules from mask-mode kept counts: vision at
    ``"nearest"``-128 or lossless ``"ceil"``-64, text at ceil-8.  ``tk=None``
    skips the text schedule."""
    vk = np.asarray(vk)
    cv = calibrate_capacities(
        vk if vk.ndim == 2 else vk[None, :], margin=margin_v,
        multiple=128 if cap_mode == "nearest" else 64, mode=cap_mode)
    if tk is None:
        return cv, None
    tk = np.asarray(tk)
    ct = calibrate_capacities(tk if tk.ndim == 2 else tk[None, :],
                              margin=margin_t, multiple=8)
    return cv, ct
