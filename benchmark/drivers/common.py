"""Helpers the drivers share: the clock, the device's memory, the
reference's weights and precision, and the comparisons of norms."""

from __future__ import annotations

import contextlib
import gc
import statistics
import time

import torch

from benchmark.weights import make_weights

now = time.perf_counter


def quantile(values, q: float) -> float:
    """The ``q`` quantile (0-1), interpolated between the closest ranks."""
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free_device():
    """Drop what the program left on the card (its graphs and their pools go
    with the model), so that the reference finds the memory free."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_weights(spec, seed: int, device):
    """The seed's weights made anew for the reference, fp32."""
    return make_weights(spec, seed, device)


@contextlib.contextmanager
def precision(tf32: bool):
    """The reference's precision: fp32 with TF32 off, or (its control) TF32
    in every matrix product and convolution."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def leaf_gap(prog: dict, ref: dict, live) -> float:
    """The worst leaf's gap between two norms, ``|prog - ref|``, over the
    larger of the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref[n] for n in live)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in live)
