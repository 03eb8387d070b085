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
layer runs: on CUDA tensors it launches kernel K1 (through
:class:`ScoringAttention`, K1 forward and K2 backward, when a gradient is
needed), on CPU tensors it runs :func:`attention_scores_plain`, which autograd
differentiates by itself.  :func:`cross_attention` is the text-over-image
cross-attention of the MED, routed the same way to kernel K4 (through
:class:`CrossAttention` when a gradient is needed) or to
:func:`cross_attention_plain`.  The JAX package's dispatch thresholds
(``FUSED_MIN_N``, ``FUSED_FULL_MAX_N``, and ``_cross_fused_eligible``'s Nq >=
8, S >= 256 and ``MADTP_FUSED_CROSS``) were set for the TPU and do not apply:
every scoring attention without an ``attn_bias`` goes through K1 on the card,
the text side's short buffers included, at any head count (CLIP's vision
tower runs it at H = 16), and every cross-attention through K4.  A scoring
attention with an ``attn_bias`` (CLIP's causal text tower) runs
:func:`attention_core` on the card too, as the JAX package's
``attention_core`` leaves its fused path whenever ``attn_bias`` is given:
K1 has no causal mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
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


def attention_scores_bwd_plain(q, k, v, key_alive, key_bias, scale: float,
                               d_out, d_cls, d_col):
    """K2's plain version: the VJP of :func:`attention_scores_plain` by
    ``torch.autograd.grad`` (the counterpart of the XLA-VJP fallback at
    ``madtp_tpu/ops/attention.py:414-420``).  ``d_out`` [B, N, H*Dh],
    ``d_cls`` and ``d_col`` [B, N-1].  Returns ``(dq, dk, dv, dbias)`` with
    ``dq, dk, dv`` shaped and typed like ``q`` and ``dbias`` fp32 [B, N].

    ``Tensor.amax``'s backward splits the gradient evenly among tied heads,
    as XLA's ``reduce_max`` VJP does."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        bias = (torch.zeros(key_alive.shape, dtype=torch.float32, device=q.device)
                if key_bias is None else key_bias.detach().float())
        bias.requires_grad_()
        outs = attention_scores_plain(*qkv, key_alive, bias, scale)
        return torch.autograd.grad(outs, (*qkv, bias), (d_out, d_cls, d_col))


class ScoringAttention(torch.autograd.Function):
    """K1 forward, K2 backward (counterpart of ``_fused_scores_diff``,
    ``_fused_fwd`` and ``_fused_bwd``, ``madtp_tpu/ops/attention.py:328-423``).

    The forward keeps K1's per-(image, head, row) max, sum-exp and fp32 row
    norm so that K2 recomputes the probabilities without another softmax
    pass.  ``q``, ``k`` and ``v`` may be views of one packed tensor or three
    tensors; each gets its own gradient, in its dtype."""

    @staticmethod
    def forward(ctx, q, k, v, key_alive, key_bias, scale):
        out, cls, col, stats = attention_scores_cuda(q, k, v, key_alive, key_bias, scale,
                                                     return_stats=True)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, key_alive, key_bias, out, stats)
        return out, cls, col

    @staticmethod
    def backward(ctx, d_out, d_cls, d_col):
        q, k, v, key_alive, key_bias, out, stats = ctx.saved_tensors
        dq, dk, dv, dbias = attention_scores_bwd_cuda(
            q, k, v, key_alive, key_bias, ctx.scale, out, stats,
            d_out.contiguous(), d_cls.contiguous(), d_col.contiguous())
        return dq, dk, dv, None, dbias, None


def attention_scores(q, k, v, key_alive, key_bias=None, scale=None):
    """Scoring self-attention (counterpart of ``_fused_scores_diff`` /
    ``_fused_forward``).  ``q, k, v``: [B, N, H, Dh]; ``key_alive`` bool
    [B, N], also the query mask of ``col_mass``; ``key_bias`` [B, N] or None.

    CUDA tensors go to the kernels, which raise on what they do not take:
    through :class:`ScoringAttention` when grad mode is on and an input
    requires a gradient, else straight to K1 (``no_grad``,
    ``inference_mode``).  CPU tensors go to the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        bias = (torch.zeros(key_alive.shape, dtype=torch.float32, device=q.device)
                if key_bias is None else key_bias.float().contiguous())
        alive = key_alive.contiguous()
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
            return ScoringAttention.apply(q, k, v, alive, bias, scale)
        return attention_scores_cuda(q, k, v, alive, bias, scale)
    if q.device.type != "cpu":
        raise ValueError(f"attention_scores runs on CUDA or CPU tensors, got {q.device}")
    return attention_scores_plain(q, k, v, key_alive, key_bias, scale)


def cross_attention_plain(q, k, v, key_alive, key_bias, scale: float):
    """K4's plain version: :func:`attention_core` without scores.  ``q``
    [B, Nq, H, Dh], ``k, v`` [B, S, H, Dh]; returns ``out`` [B, Nq, H*Dh]."""
    out, _ = attention_core(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            scale=scale, key_bias=key_bias, key_alive=key_alive)
    return out


class CrossAttention(torch.autograd.Function):
    """K4 forward; the backward recomputes the plain version and
    differentiates it (counterpart of ``_cross_fused_diff``,
    ``madtp_tpu/ops/attention.py:131-170``: the JAX package has no backward
    kernel for K4 either)."""

    @staticmethod
    def forward(ctx, q, k, v, key_alive, key_bias, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, key_alive, key_bias)
        return cross_attention_cuda(q, k, v, key_alive, key_bias, scale)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, key_alive, key_bias = ctx.saved_tensors
        need = ctx.needs_input_grad  # q, k, v, key_alive, key_bias, scale
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(n)
                   for t, n in zip((q, k, v, key_bias), need[:3] + need[4:5])]
            out = cross_attention_plain(ins[0], ins[1], ins[2], key_alive, ins[3], ctx.scale)
            grads = iter(torch.autograd.grad(
                out, [t for t in ins if t is not None and t.requires_grad], d_out))
        dq, dk, dv, dbias = (next(grads) if t is not None and t.requires_grad else None
                             for t in ins)
        return dq, dk, dv, None, dbias, None


def cross_attention(q, k, v, key_alive, key_bias=None):
    """Cross-attention of ``q`` [B, Nq, H, Dh] over ``k, v`` [B, S, H, Dh]
    (counterpart of the ``_cross_fused_diff`` branch of ``attention_core``),
    scaled by ``Dh ** -0.5``; ``key_alive`` bool [B, S], ``key_bias`` [B, S]
    or None.  Returns ``out`` [B, Nq, H*Dh].

    CUDA tensors go to K4, which raises on what it does not take: through
    :class:`CrossAttention` when grad mode is on and an input requires a
    gradient, else straight to the kernel.  CPU tensors go to the plain
    version."""
    scale = q.shape[-1] ** -0.5
    if q.is_cuda:
        alive = key_alive.contiguous()
        bias = None if key_bias is None else key_bias.float().contiguous()
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (q, k, v, bias)):
            return CrossAttention.apply(q, k, v, alive, bias, scale)
        return cross_attention_cuda(q, k, v, alive, bias, scale)
    if q.device.type != "cpu":
        raise ValueError(f"cross_attention runs on CUDA or CPU tensors, got {q.device}")
    return cross_attention_plain(q, k, v, key_alive, key_bias, scale)


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
