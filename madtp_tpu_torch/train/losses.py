"""Task losses (counterpart of ``madtp_tpu/train/losses.py:19-87``): the NLVR
cross-entropy, and retrieval's soft-target ITC over momentum features and the
queue (BLIP's over a temperature, CLIP's times ``logit_scale``, as
``madtp_tpu/train/loops.py:429-440`` computes it in place), its ITM over hard
negatives and the hard-negative sampler.  Every
loss computes in fp32 whatever the features' dtype."""

from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` [B, C] (upcast to fp32) against
    integer ``targets`` [B]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[:, None].long()).mean()


def itc_logits(feat: torch.Tensor, other_m_all: torch.Tensor, temp=None, *,
               logit_scale=None) -> torch.Tensor:
    """``feat @ other_m_all`` in fp32, divided by ``temp`` (BLIP) or, given
    ``logit_scale``, multiplied by it (CLIP, ``logit_scale * (img @ txt)``:
    a product rounds otherwise than a division by its inverse)."""
    sim = feat.float() @ other_m_all.float()
    return logit_scale * sim if logit_scale is not None else sim / temp


def itc_soft_targets(feat_m: torch.Tensor, other_m_all: torch.Tensor,
                     sim_targets: torch.Tensor, temp, alpha, *, logit_scale=None
                     ) -> torch.Tensor:
    """``alpha * softmax(itc_logits(feat_m, other_m_all)) + (1 - alpha) *
    sim_targets``: momentum features [B, E] against the other modality's
    momentum features and queue [E, B+Q]."""
    sim_m = itc_logits(feat_m, other_m_all, temp, logit_scale=logit_scale)
    return alpha * torch.softmax(sim_m, dim=1) + (1 - alpha) * sim_targets


def itc_loss(feat: torch.Tensor, other_m_all: torch.Tensor, targets: torch.Tensor,
             temp, *, logit_scale=None) -> torch.Tensor:
    """Soft-target contrastive loss of online features [B, E] against
    [E, B+Q]: the mean over rows of ``-sum(log_softmax(sim) * targets)``,
    ``sim`` from :func:`itc_logits`."""
    sim = itc_logits(feat, other_m_all, temp, logit_scale=logit_scale)
    return -(torch.log_softmax(sim, dim=1) * targets).sum(dim=1).mean()


def id_match_targets(idx: torch.Tensor, idx_all: torch.Tensor) -> torch.Tensor:
    """[B] ids against [B+Q] ids -> the row-normalized equality matrix."""
    pos = (idx[:, None] == idx_all[None, :]).float()
    return pos / pos.sum(dim=1, keepdim=True)


def gumbel(shape, *, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))`` in fp32, ``U`` uniform in
    (0, 1) drawn from ``generator`` on ``device``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def rank_noise(noise: Optional[torch.Tensor], rows: slice, cols: slice, total: int, *,
               generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """This rank's block ``[rows, cols]`` of the global batch's ``[total,
    total]`` Gumbel draw, the one ``jax.random.categorical`` makes over the
    global batch: ``noise`` when given (the global draw), else drawn from
    ``generator`` on ``device``.  A generator seeded alike on every rank
    draws the same global noise on each, so the ranks' picks are the
    one-process step's."""
    if noise is None:
        noise = gumbel((total, total), generator=generator, device=device)
    return noise[rows, cols]


@torch.no_grad()
def sample_hard_negatives(feat_a: torch.Tensor, feat_b: torch.Tensor, idx: torch.Tensor,
                          idx_world: torch.Tensor, temp, *,
                          noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          group_a: Optional[torch.Tensor] = None,
                          group_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One hard negative per row of ``feat_a`` [B, E] among ``feat_b``
    [Bw, E], drawn in proportion to ``softmax(feat_a @ feat_b.T / temp)``
    with same-id pairs (and, with groups, other groups' rows) weighted 0.
    ``jax.random.categorical`` draws it as ``argmax(log w + gumbel)``; so does
    this, with ``noise`` [B, Bw] when given, else Gumbel noise from
    ``generator`` on the features' device.  Returns [B] indices into
    ``feat_b``."""
    sim = feat_a @ feat_b.T / temp
    mask = idx[:, None] == idx_world[None, :]
    if group_a is not None:
        mask = mask | (group_a[:, None] != group_b[None, :])
    w = torch.softmax(sim, dim=1).masked_fill(mask, 0.0)
    logw = torch.log(w.clamp(min=1e-20))
    if noise is None:
        noise = gumbel(logw.shape, generator=generator, device=logw.device)
    return torch.argmax(logw + noise.to(logw.dtype), dim=1)


def itm_loss(logits: torch.Tensor, bs: int) -> torch.Tensor:
    """ITM cross-entropy of [3B, 2] logits: the first ``bs`` rows matched
    pairs, the next ``2 bs`` hard negatives."""
    labels = torch.cat([torch.ones(bs, dtype=torch.long, device=logits.device),
                        torch.zeros(2 * bs, dtype=torch.long, device=logits.device)])
    return cross_entropy(logits, labels)
