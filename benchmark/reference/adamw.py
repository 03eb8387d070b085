"""AdamW (Loshchilov & Hutter 2019) as PyTorch defines it: decoupled weight
decay on the parameter, then the bias-corrected Adam step."""

from __future__ import annotations

import math


def adamw_step(params: dict, grads: dict, state: dict, step: int, *, lr: float,
               weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """Step ``step`` (from 1) on the dict ``params``; ``state`` holds each
    parameter's two moments and is updated.  Returns the new parameters."""
    b1, b2 = betas
    out = {}
    for name, p in params.items():
        g = grads[name]
        m, v = state.get(name, (0.0 * g, 0.0 * g))
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        state[name] = (m, v)
        denom = v.sqrt() / math.sqrt(1.0 - b2 ** step) + eps
        out[name] = p * (1.0 - lr * weight_decay) - (lr / (1.0 - b1 ** step)) * m / denom
    return out
