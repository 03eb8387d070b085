"""Momentum towers and the feature queue
(counterpart of ``madtp_tpu/train/momentum.py:18-59``).  Both update in
place: the EMA through ``torch._foreach_*`` on the momentum tensors, the
queue through ``index_copy_`` at positions computed on the device, so no
step reads the queue's pointer back to the host."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


@torch.no_grad()
def momentum_update(params: Sequence[torch.Tensor], params_m: Sequence[torch.Tensor],
                    momentum: float = 0.995) -> None:
    """``m = m * momentum + p * (1 - momentum)`` for each pair, in place on
    ``params_m``."""
    params_m = list(params_m)
    torch._foreach_mul_(params_m, momentum)
    torch._foreach_add_(params_m, [p.detach() for p in params], alpha=1.0 - momentum)


class FeatureQueue(NamedTuple):
    image: torch.Tensor  # [E, Q] fp32
    text: torch.Tensor  # [E, Q] fp32
    idx: torch.Tensor  # [Q] long, -100 where empty
    ptr: torch.Tensor  # 0-d long on the queue's device


def init_queue(embed_dim: int, queue_size: int, seed: int, device) -> FeatureQueue:
    """Normal features from a ``torch.Generator`` seeded with ``seed`` (drawn
    on the CPU, so every device gets the same queue), L2-normalized per
    column, moved to ``device``; ids -100; the pointer 0."""
    g = torch.Generator().manual_seed(seed)
    img, txt = (torch.randn(embed_dim, queue_size, generator=g) for _ in range(2))
    img, txt = (t / torch.linalg.vector_norm(t, dim=0, keepdim=True) for t in (img, txt))
    return FeatureQueue(img.to(device), txt.to(device),
                        torch.full((queue_size,), -100, dtype=torch.long, device=device),
                        torch.zeros((), dtype=torch.long, device=device))


@torch.no_grad()
def enqueue(q: FeatureQueue, image_feat: torch.Tensor, text_feat: torch.Tensor,
            idx: torch.Tensor) -> None:
    """Write a batch's features [B, E] (as fp32) and ids at the pointer and
    advance it by B modulo the queue size, in place.  The queue size is a
    multiple of B, as the reference requires, so a batch never straddles
    the end."""
    size = q.idx.shape[0]
    pos = (q.ptr + torch.arange(image_feat.shape[0], device=q.ptr.device)) % size
    q.image.index_copy_(1, pos, image_feat.T.float())
    q.text.index_copy_(1, pos, text_feat.T.float())
    q.idx.index_copy_(0, pos, idx.long())
    q.ptr.copy_((q.ptr + image_feat.shape[0]) % size)
