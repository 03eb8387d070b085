"""Capacity-schedule calibration for gather-mode DTP
(copy of ``madtp_tpu/prune/calibrate.py:18-58``): per-layer buffer sizes from
mask-mode kept counts, with a margin, rounded to a multiple."""

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
