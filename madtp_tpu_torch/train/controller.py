"""GFLOPs-targeted temperature controller
(copy of ``madtp_tpu/train/controller.py:14-53``): a bang-bang ladder on the
gap between the measured and the target GFLOPs, and the iterated pre-search
``compress_caption`` runs before training."""

from __future__ import annotations

import dataclasses

_LADDER = ((30.0, 1.0), (10.0, 0.5), (5.0, 0.25), (1.0, 0.1))


def temperature_step(cur_gflops: float, target_gflops: float) -> float:
    """Signed temperature increment for one controller update."""
    diff = cur_gflops - target_gflops
    mag = abs(diff)
    for threshold, step in _LADDER:
        if mag > threshold:
            return step if diff > 0 else -step
    return 0.01 if diff > 0 else -0.01


@dataclasses.dataclass
class TemperatureController:
    """Per-epoch controller state; the temperature starts at 1.0."""

    target_gflops: float
    temperature: float = 1.0

    def update(self, cur_gflops: float) -> float:
        self.temperature += temperature_step(cur_gflops, self.target_gflops)
        return self.temperature


def presearch_temperature(measure, target_gflops: float, *, t0: float = 1.0,
                          max_iters: int = 25, tol: float = 1.0) -> float:
    """Measure and step until within ``tol`` GFLOPs of the target or out of
    iterations; ``measure(t) -> gflops``."""
    t = t0
    for _ in range(max_iters):
        g = measure(t)
        if abs(g - target_gflops) <= tol:
            break
        t += temperature_step(g, target_gflops)
        t = max(t, 1e-3)
    return t
