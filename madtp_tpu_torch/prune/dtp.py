"""Dynamic Token Pruning with static shapes
(counterpart of ``madtp_tpu/prune/dtp.py:50-396``).

Every non-CLS token is scored by the mean of three normalized signals
(column mass, MAG token-codebook affinity, head-weighted CLS attention); a
per-sample threshold comes from a temperature softmax over the codebook
attention; the batch keeps the batch-max count of above-threshold tokens and
merges every dropped token into one by score-weighted sum.

* mask mode (:func:`dtp_prune`): a fixed buffer with an ``alive`` mask and one
  pre-allocated merge slot per layer.  No shape changes and no host sync: the
  keep count stays a device scalar used only in comparisons.
* gather mode (:func:`dtp_prune_gather`): the same decisions, then a physical
  compaction to a static capacity.

Ranking is a stable descending sort, so ties go to the lower index.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

NEG_INF = float("-inf")


class TokenState(NamedTuple):
    """``x`` [B, S, D] (slot 0 is CLS, never pruned); ``alive`` [B, S] bool;
    ``bias`` [B, S] additive key bias (text padding) or None."""

    x: torch.Tensor
    alive: torch.Tensor
    bias: Optional[torch.Tensor]


class DTPSignals(NamedTuple):
    """Per-layer scoring inputs over slots 1..S-1."""

    cls_attn: torch.Tensor  # [B, P]
    col_mass: torch.Tensor  # [B, P], dead columns exactly 0
    token_attn: torch.Tensor  # [B, P, K] raw MAG inner products


def init_token_state(tokens: torch.Tensor, depth: int,
                     bias: Optional[torch.Tensor] = None,
                     pad_to: int = 1) -> TokenState:
    """Pad with ``depth`` dead merge slots to ``N + depth`` slots, rounded up
    to a multiple of ``pad_to``; the extra slots start dead."""
    B, N, D = tokens.shape
    S = N + depth
    if pad_to > 1:
        S = ((S + pad_to - 1) // pad_to) * pad_to
    extra = S - N
    x = torch.cat([tokens, tokens.new_zeros((B, extra, D))], dim=1)
    alive = torch.zeros((B, S), dtype=torch.bool, device=tokens.device)
    alive[:, :N] = True
    if bias is not None:
        bias = torch.cat([bias, bias.new_zeros((B, extra))], dim=1)
    return TokenState(x=x, alive=alive, bias=bias)


def importance_score(signals: DTPSignals, palive: torch.Tensor) -> torch.Tensor:
    """Mean of the three normalized signals; dead slots score 0.  [B, P]."""
    col = signals.col_mass
    col_w = col / (col.sum(dim=1, keepdim=True) + 1e-8)
    tw = signals.token_attn.amax(dim=2)
    tw = torch.where(palive, tw, torch.zeros_like(tw))
    tw = tw / (tw.sum(dim=1, keepdim=True) + 1e-8)
    cls_w = torch.where(palive, signals.cls_attn, torch.zeros_like(signals.cls_attn))
    return (col_w + tw + cls_w) / 3.0


def dtp_threshold(token_attn: torch.Tensor, score: torch.Tensor,
                  palive: torch.Tensor, temperature: torch.Tensor) -> torch.Tensor:
    """Per-sample threshold ``min_k softmax_tokens(token_attn / T)[:, :, k] . score``."""
    logits = (token_attn / temperature).masked_fill(~palive[:, :, None], NEG_INF)
    w = torch.softmax(logits, dim=1)  # over tokens
    score_weight = torch.einsum("bpk,bp->bk", w, score.float())
    return score_weight.amin(dim=1)


def _invert_permutation(order: torch.Tensor) -> torch.Tensor:
    """inv[b, order[b, i]] = i."""
    inv = torch.empty_like(order)
    iota = torch.arange(order.shape[1], device=order.device).expand_as(order)
    return inv.scatter_(1, order, iota)


def _merge_dropped(w: torch.Tensor, patches: torch.Tensor) -> torch.Tensor:
    """Score-weighted sum of the dropped tokens, accumulated in fp32."""
    return torch.einsum("bp,bpd->bd", w, patches.float()).to(patches.dtype)


def _keep_rule(score, signals, palive, temperature, row_independent, variant="vit",
               max_keep=None):
    """The decision both modes share: ``(order, topk_num, alive_cnt,
    apply)``, with ``order`` the stable descending ranking of alive slots.

    The step applies when it keeps at least one token (``variant="vit"``,
    the ViT and MED) or more than ``max_keep`` (``variant="clip"``, default
    1; the text tower passes ``max(eot_pos) + 2`` as a device tensor, so the
    guard keeps the EOT token without a host sync), and drops at least two."""
    if torch.is_tensor(temperature):
        temperature = temperature.to(torch.float32)
    else:
        # a fill kernel: torch.as_tensor of a Python float would copy it from
        # the host and synchronize the stream, once per layer
        temperature = torch.full((), float(temperature), dtype=torch.float32,
                                 device=score.device)
    thr = dtp_threshold(signals.token_attn, score, palive, temperature)
    counts = (palive & (score > thr[:, None])).sum(dim=1)
    if row_independent:
        topk_num = counts
        alive_cnt = palive.sum(dim=1)
    else:
        topk_num = counts.amax()
        alive_cnt = palive.sum(dim=1).amax()
    if variant == "clip":
        apply = (topk_num > (1 if max_keep is None else max_keep)) & (alive_cnt - topk_num >= 2)
    elif variant == "vit":
        apply = (topk_num >= 1) & (alive_cnt - topk_num >= 2)
    else:
        raise ValueError(f"unknown DTP variant {variant!r}")
    score_ranked = torch.where(palive, score, torch.full_like(score, NEG_INF))
    order = torch.argsort(-score_ranked, dim=-1, stable=True)
    return order, topk_num, alive_cnt, apply


def dtp_prune(state: TokenState, signals: DTPSignals, temperature, merge_slot: int,
              *, variant: str = "vit", max_keep=None,
              row_independent: bool = False) -> Tuple[TokenState, torch.Tensor]:
    """One mask-mode DTP step.  Returns ``(new_state, kept)``: ``kept`` is
    the batch-uniform count of alive non-CLS slots after pruning, merged
    token included (per row ``[B]`` when ``row_independent``).  Skipped when
    nothing or almost everything would be pruned (``variant`` and
    ``max_keep``: :func:`_keep_rule`)."""
    x, alive, bias = state
    B, S, D = x.shape
    palive = alive[:, 1:]
    P = S - 1

    score = importance_score(signals, palive)
    order, topk_num, alive_cnt, apply = _keep_rule(
        score, signals, palive, temperature, row_independent, variant, max_keep)
    ranks = _invert_permutation(order)
    kcol = topk_num[:, None] if row_independent else topk_num
    keep = palive & (ranks < kcol)

    merge_mask = palive & ~keep
    w = torch.where(merge_mask, score, torch.zeros_like(score))
    w = w / (w.sum(dim=1, keepdim=True) + 1e-8)
    merged = _merge_dropped(w, x[:, 1:])

    is_merge_slot = torch.arange(S, device=x.device)[None, :] == merge_slot
    new_alive = torch.cat([alive[:, :1], keep], dim=1) | is_merge_slot
    new_x = torch.where(is_merge_slot[:, :, None], merged[:, None, :], x)
    new_bias = bias
    if bias is not None:
        # the merged slot inherits the bias of the best dropped token (rank
        # topk_num): the reference gathers topk_num+1 indices and the mask
        # rides along
        rank_k = kcol if row_independent else topk_num.expand(B, 1)
        rank_k_tok = torch.gather(order, 1, rank_k.clamp_max(P - 1))
        merged_bias = torch.gather(bias[:, 1:], 1, rank_k_tok)[:, 0]
        new_bias = torch.where(is_merge_slot, merged_bias[:, None], bias)

    ax = apply[:, None, None] if row_independent else apply
    aa = apply[:, None] if row_independent else apply
    out = TokenState(
        x=torch.where(ax, new_x, x),
        alive=torch.where(aa, new_alive, alive),
        bias=None if bias is None else torch.where(aa, new_bias, bias),
    )
    kept = torch.where(apply, topk_num + 1, alive_cnt)
    return out, kept


def compact(state: TokenState, capacity: int) -> Tuple[TokenState, torch.Tensor]:
    """Gather-mode compaction to ``capacity`` slots: slot 0, then alive slots
    in slot order, then dead ones.  Returns the state and the gather indices."""
    x, alive, bias = state
    B, S, D = x.shape
    if capacity > S:
        raise ValueError(f"capacity {capacity} exceeds the buffer's {S} slots")
    slots = torch.arange(1, S, device=x.device, dtype=torch.float32)[None, :]
    prio = torch.where(alive[:, 1:], -slots, torch.full_like(slots, NEG_INF))
    idx = torch.argsort(-prio, dim=-1, stable=True)[:, :capacity - 1] + 1
    idx = torch.cat([idx.new_zeros((B, 1)), idx], dim=1)
    gx = torch.gather(x, 1, idx[:, :, None].expand(B, capacity, D))
    galive = torch.gather(alive, 1, idx)
    gbias = None if bias is None else torch.gather(bias, 1, idx)
    return TokenState(gx, galive, gbias), idx


def dtp_prune_gather(state: TokenState, signals: DTPSignals, temperature,
                     capacity: int, *, variant: str = "vit", max_keep=None,
                     row_independent: bool = False
                     ) -> Tuple[TokenState, torch.Tensor, torch.Tensor]:
    """DTP step plus compaction to ``capacity`` slots: slot 0 = CLS, slots
    ``1..capacity-2`` the highest-scored tokens (alive for the first
    ``topk_num``), slot ``capacity-1`` the merged token.  Kept tokens beyond
    ``capacity - 2`` overflow into the merged token and are counted.

    Returns ``(new_state, kept, overflow)``; with ``row_independent`` ``kept``
    is the per-row decision count (overflow included)."""
    x, alive, bias = state
    B, S, D = x.shape
    palive = alive[:, 1:]
    cap_p = capacity - 2

    score = importance_score(signals, palive)
    order, topk_num, alive_cnt, apply = _keep_rule(
        score, signals, palive, temperature, row_independent, variant, max_keep)

    eff_keep = torch.where(apply, topk_num.clamp_max(cap_p), alive_cnt.clamp_max(cap_p))
    overflow = (torch.where(apply, topk_num, alive_cnt) - cap_p).clamp_min(0)
    eff_keep_col = eff_keep[:, None] if row_independent else eff_keep

    sel = order[:, :cap_p]
    ranks_sel = torch.arange(cap_p, device=x.device)[None, :]
    sel_alive = torch.gather(palive, 1, sel) & (ranks_sel < eff_keep_col)
    gx = torch.gather(x[:, 1:], 1, sel[:, :, None].expand(B, cap_p, D))
    gbias = None if bias is None else torch.gather(bias[:, 1:], 1, sel)

    rank_full = _invert_permutation(order)
    merge_mask = palive & (rank_full >= eff_keep_col)
    w = torch.where(merge_mask, score, torch.zeros_like(score))
    w = w / (w.sum(dim=1, keepdim=True) + 1e-8)
    merged = _merge_dropped(w, x[:, 1:])

    do_merge = apply | (overflow > 0)
    new_x = torch.cat([x[:, :1], gx, merged[:, None, :]], dim=1)
    merge_col = do_merge[:, None] if row_independent else do_merge.expand(B, 1)
    new_alive = torch.cat([alive[:, :1], sel_alive, merge_col], dim=1)
    new_bias = None
    if bias is not None:
        rank_k = eff_keep[:, None] if row_independent else eff_keep.expand(B, 1)
        rank_k_tok = torch.gather(order, 1, rank_k)
        merged_bias = torch.gather(bias[:, 1:], 1, rank_k_tok)
        new_bias = torch.cat([bias[:, :1], gbias, merged_bias], dim=1)
    kept = eff_keep + do_merge.to(eff_keep.dtype)
    if row_independent:
        kept = kept + overflow
    return TokenState(new_x, new_alive, new_bias), kept, overflow
