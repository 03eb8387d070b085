"""Plain PyTorch MADTP token pruning, written from the method's description
(Cao et al., "MADTP", CVPR 2024; the reference code's ``Block.Reduce_token``
and ``query_model``): the benchmark's yardstick, independent of the program.

Each non-CLS token is scored by the mean of three normalized signals: the
attention mass it receives (the head maximum, summed over the query rows),
its largest affinity to a codebook entry, and the head-weighted attention
of the CLS query.  A row's threshold is the smallest, over the codebook
entries, of the scores averaged under a softmax of the tokens' affinity to
that entry at the temperature.  The batch keeps as many tokens as its
fullest row has above threshold, ranked by score (stable, lower slot first
on ties), and merges the rest into one token by score-weighted sum.

Two forms:

* :func:`prune_physical` removes the dropped tokens: the kept tokens in rank
  order, then the merged one.  Given a capacity (the "gather" schedule),
  at most ``capacity - 2`` tokens are kept and any beyond are merged too.
* :func:`prune_masked` keeps a fixed buffer with an alive mask and writes
  the merged token into a slot of its own (the CLIP text tower, whose
  features are read at a fixed slot).

Everything runs in the dtype of its inputs; the caller decides the
precision (fp32 with TF32 off for the reference, TF32 for its control).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = float("-inf")


class Signals(NamedTuple):
    cls_attn: torch.Tensor  # [B, P]
    col_mass: torch.Tensor  # [B, P]
    token_attn: torch.Tensor  # [B, P, K]


def attend(q, k, v, heads: int, *, key_bias=None, key_alive=None, attn_bias=None):
    """Multi-head attention over ``q`` [B, Nq, D], ``k, v`` [B, Nk, D].
    Returns ``(out [B, Nq, D], probs [B, H, Nq, Nk], per-head out
    [B, H, Nq, Dh])``.  ``key_bias`` [B, Nk] is added to the logits; a key
    that is not alive gets no weight."""
    B, Nq, D = q.shape
    Nk = k.shape[1]
    Dh = D // heads
    qh = q.reshape(B, Nq, heads, Dh).transpose(1, 2)
    kh = k.reshape(B, Nk, heads, Dh).transpose(1, 2)
    vh = v.reshape(B, Nk, heads, Dh).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) * Dh ** -0.5
    if attn_bias is not None:
        logits = logits + attn_bias
    if key_bias is not None:
        logits = logits + key_bias[:, None, None, :]
    if key_alive is not None:
        logits = logits.masked_fill(~key_alive[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out_h = probs @ vh
    return out_h.transpose(1, 2).reshape(B, Nq, D), probs, out_h


def scores_of(probs, out_h, query_alive=None):
    """``(cls_attn, col_mass)`` over the slots 1..N-1: the CLS query's
    attention weighted per token by each head's share of the token's output
    norm, and the head maximum of the attention each key receives, summed
    over the (alive) query rows 1..N-1."""
    head_imp = torch.linalg.vector_norm(out_h[:, :, 1:], dim=-1)
    head_imp = head_imp / (head_imp.sum(dim=1, keepdim=True) + 1e-8)
    cls_attn = (probs[:, :, 0, 1:] * head_imp).sum(dim=1)
    colmax = probs[:, :, 1:, 1:].amax(dim=1)
    if query_alive is not None:
        colmax = colmax * query_alive[:, 1:, None].to(colmax.dtype)
    return cls_attn, colmax.sum(dim=1)


def codebook_query(tokens, codebook):
    """Token-codebook affinity ``[B, P, K]`` (raw inner products) and the
    codebook-pooled token features ``[B, K, D]`` (a softmax over the tokens
    of the affinity over sqrt(D)).  Every token given is alive."""
    token_attn = tokens @ codebook.t()
    w = torch.softmax(token_attn.transpose(1, 2) / codebook.shape[-1] ** 0.5, dim=-1)
    return token_attn, w @ tokens


def _decide(sig: Signals, temperature, palive, variant: str, max_keep):
    """The score, the ranking and the batch's keep count, the alive count
    and whether the step applies (keeps at least one token, more than
    ``max_keep`` for CLIP, and drops at least two)."""
    zero = torch.zeros_like(sig.cls_attn)
    col = sig.col_mass
    col_w = col / (col.sum(dim=1, keepdim=True) + 1e-8)
    tw = torch.where(palive, sig.token_attn.amax(dim=2), zero)
    tw = tw / (tw.sum(dim=1, keepdim=True) + 1e-8)
    cls_w = torch.where(palive, sig.cls_attn, zero)
    score = (col_w + tw + cls_w) / 3.0
    t = torch.as_tensor(temperature, dtype=sig.token_attn.dtype, device=score.device)
    logits = (sig.token_attn / t).masked_fill(~palive[:, :, None], NEG_INF)
    w = torch.softmax(logits, dim=1)
    thr = torch.einsum("bpk,bp->bk", w, score).amin(dim=1)
    topk = int((palive & (score > thr[:, None])).sum(dim=1).max())
    alive_cnt = int(palive.sum(dim=1).max())
    floor = 1 if variant == "clip" and max_keep is None else max_keep
    if variant == "clip":
        apply = topk > floor and alive_cnt - topk >= 2
    else:
        apply = topk >= 1 and alive_cnt - topk >= 2
    ranked = torch.where(palive, score, torch.full_like(score, NEG_INF))
    order = torch.argsort(-ranked.detach(), dim=-1, stable=True)
    return score, order, topk, alive_cnt, apply


def _merge(score, patches, idx):
    w = torch.gather(score, 1, idx)
    w = w / (w.sum(dim=1, keepdim=True) + 1e-8)
    rows = torch.gather(patches, 1, idx[:, :, None].expand(-1, -1, patches.shape[-1]))
    return torch.einsum("bp,bpd->bd", w, rows)


def prune_physical(x, sig: Signals, temperature, *, capacity: Optional[int] = None,
                   bias=None, variant: str = "vit", max_keep=None):
    """One pruning step on ``x`` [B, N, D] (slot 0 CLS, all alive) with the
    text padding ``bias`` [B, N] or None.  Returns ``(x, bias, kept,
    overflow)``: ``kept`` the non-CLS tokens left (merged one included),
    ``overflow`` the kept tokens that did not fit ``capacity`` and were
    merged."""
    B, N, D = x.shape
    palive = torch.ones((B, N - 1), dtype=torch.bool, device=x.device)
    score, order, topk, alive_cnt, apply = _decide(sig, temperature, palive, variant,
                                                   max_keep)
    want = topk if apply else alive_cnt
    keep_n, overflow = want, 0
    if capacity is not None:
        keep_n = min(want, capacity - 2)
        overflow = want - keep_n
    merge = apply or overflow > 0
    patches = x[:, 1:]
    keep_idx = order[:, :keep_n]
    parts = [x[:, :1], torch.gather(patches, 1, keep_idx[:, :, None].expand(-1, -1, D))]
    if merge:
        parts.append(_merge(score, patches, order[:, keep_n:])[:, None])
    new_bias = None
    if bias is not None:
        pb = bias[:, 1:]
        bparts = [bias[:, :1], torch.gather(pb, 1, keep_idx)]
        if merge:  # the merged token takes the padding of the best dropped one
            bparts.append(torch.gather(pb, 1, order[:, keep_n:keep_n + 1]))
        new_bias = torch.cat(bparts, dim=1)
    return torch.cat(parts, dim=1), new_bias, keep_n + int(merge), overflow


def prune_masked(x, alive, sig: Signals, temperature, merge_slot: int, *,
                 variant: str = "vit", max_keep=None):
    """One pruning step on a fixed buffer ``x`` [B, S, D] with ``alive``
    [B, S]: dropped slots die, the merged token lives in ``merge_slot``.
    Returns ``(x, alive, kept)``."""
    B, S, D = x.shape
    palive = alive[:, 1:]
    score, order, topk, alive_cnt, apply = _decide(sig, temperature, palive, variant,
                                                   max_keep)
    if not apply:
        return x, alive, alive_cnt
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(S - 1, device=x.device).expand_as(order))
    keep = palive & (ranks < topk)
    dropped = palive & ~keep
    w = torch.where(dropped, score, torch.zeros_like(score))
    w = w / (w.sum(dim=1, keepdim=True) + 1e-8)
    merged = torch.einsum("bp,bpd->bd", w, x[:, 1:])
    slot = torch.arange(S, device=x.device)[None, :] == merge_slot
    new_x = torch.where(slot[:, :, None], merged[:, None, :], x)
    new_alive = torch.cat([alive[:, :1], keep], dim=1) | slot
    return new_x, new_alive, topk + 1
