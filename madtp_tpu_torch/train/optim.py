"""Optimizer and learning-rate schedules
(counterpart of ``madtp_tpu/train/optim.py:11-44``)."""

from __future__ import annotations

import math
from typing import Iterable

import torch


def cosine_lr(epoch: int, max_epoch: int, init_lr: float, min_lr: float) -> float:
    """Per-epoch cosine decay from ``init_lr`` to ``min_lr``."""
    return (init_lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * epoch / max_epoch)) + min_lr


def warmup_lr(step: int, max_step: int, init_lr: float, warmup_lr_v: float) -> float:
    """Linear warmup from ``warmup_lr_v`` to ``init_lr``."""
    return min(init_lr, warmup_lr_v + (init_lr - warmup_lr_v) * step / max(max_step, 1))


def step_lr(epoch: int, init_lr: float, min_lr: float, decay_rate: float = 1.0) -> float:
    """Exponential step decay, floored at ``min_lr``."""
    return max(min_lr, init_lr * (decay_rate ** epoch))


def make_adamw(params: Iterable[torch.nn.Parameter], lr: float,
               weight_decay: float) -> torch.optim.AdamW:
    """AdamW with betas (0.9, 0.999) and eps 1e-8, decaying every parameter,
    as ``optax.adamw`` does with no mask."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the learning rate of every parameter group (the counterpart of
    ``optax.inject_hyperparams``, ``make_adamw_injectable``)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
