"""MAG query: tokens against the shared FDT codebook
(counterpart of ``madtp_tpu/prune/query.py:26-50``).  CLIP's blocks first map
the tokens to the codebook's width with their own ``q_map`` linear
(``map_func=True`` there, reference ``clip/model.py:188``)."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from madtp_tpu_torch.ops.layers import linear


def query_model(ft: torch.Tensor, sd: torch.Tensor,
                alive: Optional[torch.Tensor] = None,
                q_map: Optional[torch.nn.Linear] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ft`` [B, P, D] tokens, ``sd`` [K, sd_dim] codebook, ``alive``
    [B, P]; ``q_map`` a linear D -> sd_dim applied to the tokens first
    (without it D must be sd_dim).

    Returns ``(token_attn [B, P, K], sd_ft [B, K, sd_dim])``: ``token_attn``
    is the raw, unscaled fp32 inner product; ``sd_ft`` pools the (mapped)
    tokens per code with a softmax over alive tokens of ``token_attn /
    sqrt(sd_dim)``, in ``ft``'s dtype.
    """
    if q_map is not None:
        ft = linear(ft, q_map.weight, q_map.bias)
    ftf = ft.float()
    token_attn = torch.matmul(ftf, sd.float().t())
    logits = (token_attn / math.sqrt(sd.shape[-1])).transpose(1, 2)  # [B, K, P]
    if alive is not None:
        logits = logits.masked_fill(~alive[:, None, :], float("-inf"))
    att_w = torch.softmax(logits, dim=-1)
    sd_ft = torch.matmul(att_w, ftf)
    return token_attn, sd_ft.to(ft.dtype)
