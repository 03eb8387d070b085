"""Multi-head attention with the DTP scoring side outputs
(counterpart of ``madtp_tpu/ops/attention.py:173-365``).

* ``cls_attn`` — head-diversity-weighted CLS attention:
  ``sum_h probs[b,h,0,n] * r_h[n] / (sum_h r_h[n] + 1e-8)`` with
  ``r_h[n] = ||out_h[n]||``;
* ``col_mass`` — ``sum over alive queries m >= 1 of max_h probs[b,h,m,n]``.

Masking: dead keys get ``-inf`` (exactly zero weight), the finite per-key
bias (text padding) is added before the mask, and a row with no alive key
gives zeros, not NaN.

:func:`attention_core` is the plain PyTorch version (never
``F.scaled_dot_product_attention``, which returns NaN on fully masked rows).
:func:`attention_scores` is the scoring self-attention that every pruned
layer runs: on CUDA tensors it launches kernel K1, on CPU tensors it runs
:func:`attention_scores_plain`.  The JAX package's dispatch thresholds
(``FUSED_MIN_N``, ``FUSED_FULL_MAX_N``) were set for the TPU's lanes and do
not apply: every scoring attention on the card goes through K1, the text
side's short buffers included.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
from madtp_tpu_torch.ops.layers import linear


class AttnAux(NamedTuple):
    cls_attn: Optional[torch.Tensor]  # [B, N-1]
    col_mass: Optional[torch.Tensor]  # [B, N-1] (un-normalized)


def attention_core(
    q: torch.Tensor,  # [B, H, Nq, Dh]
    k: torch.Tensor,  # [B, H, Nk, Dh]
    v: torch.Tensor,  # [B, H, Nk, Dh]
    *,
    scale: Optional[float] = None,
    attn_bias: Optional[torch.Tensor] = None,  # additive, broadcastable to [B,H,Nq,Nk]
    key_bias: Optional[torch.Tensor] = None,  # additive per key [B, Nk]
    key_alive: Optional[torch.Tensor] = None,  # [B, Nk] bool; False -> weight exactly 0
    query_alive: Optional[torch.Tensor] = None,  # [B, Nq] bool; rows summed into col_mass
    need_scores: bool = False,
):
    """Plain attention.  Returns ``(out [B, Nq, H*Dh], AttnAux)``; the scores
    need ``Nq == Nk`` with slot 0 the CLS token.  Logits and probabilities
    are fp32; the probabilities are cast to ``v``'s dtype for the value
    product, as in the JAX package."""
    B, H, Nq, Dh = q.shape
    if scale is None:
        scale = Dh ** -0.5
    if key_bias is not None:
        b4 = key_bias[:, None, None, :]
        attn_bias = b4 if attn_bias is None else attn_bias + b4

    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if attn_bias is not None:
        logits = logits + attn_bias.float()
    if key_alive is not None:
        logits = logits.masked_fill(~key_alive[:, None, None, :], float("-inf"))

    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m)
    s = e.sum(dim=-1, keepdim=True)
    probs = e / s.clamp_min(1e-30)  # fp32 [B,H,Nq,Nk]

    attn_out = torch.matmul(probs.to(v.dtype), v)  # [B,H,Nq,Dh]
    out = attn_out.transpose(1, 2).reshape(B, Nq, H * Dh)
    if not need_scores:
        return out, AttnAux(None, None)

    head_imp = torch.linalg.vector_norm(attn_out[:, :, 1:, :].float(), dim=-1)
    head_imp = head_imp / (head_imp.sum(dim=1, keepdim=True) + 1e-8)
    cls_attn = (probs[:, :, 0, 1:] * head_imp).sum(dim=1)
    colmax = probs[:, :, 1:, 1:].amax(dim=1)  # [B, Nq-1, Nk-1]
    if query_alive is not None:
        colmax = colmax * query_alive[:, 1:, None].to(colmax.dtype)
    col_mass = colmax.sum(dim=1)
    return out, AttnAux(cls_attn=cls_attn, col_mass=col_mass)


def attention_scores_plain(q, k, v, key_alive, key_bias, scale: float):
    """K1's plain version: :func:`attention_core` with ``need_scores=True``,
    alive rows as the queries.  ``q, k, v`` in [B, N, H, Dh]; returns
    ``(out [B, N, H*Dh], cls_attn [B, N-1], col_mass [B, N-1])``."""
    out, aux = attention_core(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale,
        key_bias=key_bias, key_alive=key_alive, query_alive=key_alive,
        need_scores=True)
    return out, aux.cls_attn, aux.col_mass


def attention_scores(q, k, v, key_alive, key_bias=None, scale=None):
    """Scoring self-attention (counterpart of ``_fused_scores_diff`` /
    ``_fused_forward``).  ``q, k, v``: [B, N, H, Dh]; ``key_alive`` bool
    [B, N], also the query mask of ``col_mass``; ``key_bias`` [B, N] or None.

    CUDA tensors go to kernel K1 (which raises on what it does not take);
    CPU tensors to the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        bias = (torch.zeros(key_alive.shape, dtype=torch.float32, device=q.device)
                if key_bias is None else key_bias.float().contiguous())
        return attention_scores_cuda(q, k, v, key_alive.contiguous(), bias, scale)
    if q.device.type != "cpu":
        raise ValueError(f"attention_scores runs on CUDA or CPU tensors, got {q.device}")
    return attention_scores_plain(q, k, v, key_alive, key_bias, scale)


def multi_head_attention(q, k, v, num_heads: int, *, key_alive=None,
                         key_bias=None, need_scores: bool = False):
    """Attention over projected ``q`` [B, Nq, D] and ``k, v`` [B, Nk, D]
    (views of a packed qkv tensor are fine).  With ``need_scores`` this is the
    scoring self-attention (:func:`attention_scores`), else the plain core.
    Returns ``(out [B, Nq, D], AttnAux)``."""
    Dh = q.shape[-1] // num_heads
    qh, kh, vh = (t.unflatten(-1, (num_heads, Dh)) for t in (q, k, v))
    if need_scores:
        out, cls_attn, col_mass = attention_scores(qh, kh, vh, key_alive, key_bias)
        return out, AttnAux(cls_attn, col_mass)
    return attention_core(qh.transpose(1, 2), kh.transpose(1, 2),
                          vh.transpose(1, 2), key_bias=key_bias,
                          key_alive=key_alive)


def self_attention(x, qkv: torch.nn.Linear, proj: torch.nn.Linear, num_heads: int,
                   *, key_alive=None, need_scores: bool = False):
    """BLIP-ViT self-attention with packed qkv and output projection
    (``madtp_tpu/ops/attention.py:274-310``)."""
    D = x.shape[-1]
    packed = linear(x, qkv.weight, qkv.bias)  # [B, N, 3D]
    q, k, v = packed[..., :D], packed[..., D:2 * D], packed[..., 2 * D:]
    out, aux = multi_head_attention(q, k, v, num_heads, key_alive=key_alive,
                                    need_scores=need_scores)
    return linear(out, proj.weight, proj.bias), aux
