"""MAG query: tokens against the shared FDT codebook
(counterpart of ``madtp_tpu/prune/query.py:26-50``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def query_model(ft: torch.Tensor, sd: torch.Tensor,
                alive: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ft`` [B, P, D] tokens, ``sd`` [K, D] codebook, ``alive`` [B, P].

    Returns ``(token_attn [B, P, K], sd_ft [B, K, D])``: ``token_attn`` is the
    raw, unscaled fp32 inner product; ``sd_ft`` pools the tokens per code with
    a softmax over alive tokens of ``token_attn / sqrt(D)``, in ``ft``'s dtype.
    """
    ftf = ft.float()
    token_attn = torch.matmul(ftf, sd.float().t())
    logits = (token_attn / math.sqrt(sd.shape[-1])).transpose(1, 2)  # [B, K, P]
    if alive is not None:
        logits = logits.masked_fill(~alive[:, None, :], float("-inf"))
    att_w = torch.softmax(logits, dim=-1)
    sd_ft = torch.matmul(att_w, ftf)
    return token_attn, sd_ft.to(ft.dtype)
