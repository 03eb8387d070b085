"""Task losses (counterpart of ``madtp_tpu/train/losses.py:85-87``).  Only
what NLVR trains with; ITC, ITM and hard negatives wait for retrieval."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` [B, C] (upcast to fp32) against
    integer ``targets`` [B]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[:, None].long()).mean()
