"""NLVR2 evaluation (counterpart of ``madtp_tpu/tasks/nlvr.py:27-170``):
the eval step, the single-process eval loop that returns the analytic
per-sample GFLOPs, and the capacity-schedule helper of the fast eval
(``madtp_tpu/cli/common.py:257-276``)."""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from madtp_tpu_torch.models.blip import NLVRModel, NLVROut
from madtp_tpu_torch.prune.calibrate import calibrate_capacities
from madtp_tpu_torch.prune.flops import nlvr_gflops


def make_eval_step(model: NLVRModel, prune_active: bool,
                   capacities_v: Optional[Sequence[int]] = None,
                   capacities_t: Optional[Sequence[int]] = None):
    """``step(images, ids, mask, temperature) -> NLVROut`` without autograd;
    capacities select gather mode."""
    @torch.inference_mode()
    def step(images, ids, mask, temperature) -> NLVROut:
        return model(images, ids, mask, temperature=temperature,
                     prune_active=prune_active, capacities_v=capacities_v,
                     capacities_t=capacities_t)
    return step


def evaluate(model: NLVRModel, loader_fn: Callable[[], Iterable], tokenize,
             temperature: float, *, prune_active: bool, enc_token_id: int,
             capacities_v=None, capacities_t=None, print_fn=print,
             print_freq: int = 50) -> Tuple[dict, float]:
    """Returns ``(stats, Cur_Gflops)``.  ``loader_fn()`` yields
    ``(image0, image1, sentences, targets)`` numpy batches; ``tokenize`` maps
    the sentences to numpy ``(ids, mask)``.  Batch ``i+1`` is dispatched
    before batch ``i`` is read back, so the card does not wait on the host
    loop.  ``stats`` holds the accuracy and, in gather mode, the overflow
    count summed over batches."""
    cfg = model.cfg
    device = model.space_dict.device
    step = make_eval_step(model, prune_active, capacities_v, capacities_t)
    correct, seen, gflops_sum, n_batches, overflow = 0, 0, 0.0, 0, 0

    def consume(pend):
        nonlocal correct, seen, gflops_sum, n_batches, overflow
        out, targets, text_w = pend
        preds = out.logits.float().argmax(-1).cpu().numpy()
        correct += int((preds == np.asarray(targets)).sum())
        seen += len(targets)
        if prune_active:
            g = nlvr_gflops(cfg.vit, cfg.med, out.v_kept.cpu().numpy(),
                            out.t_kept.cpu().numpy(), text_w)
        else:
            g = nlvr_gflops(cfg.vit, cfg.med, [cfg.vit.num_patches] * cfg.vit.depth,
                            [text_w - 1] * cfg.med.num_hidden_layers, text_w)
        if out.overflow is not None:
            overflow += int(out.overflow)
        gflops_sum += g
        n_batches += 1

    pending = None
    for i, (image0, image1, sentences, targets) in enumerate(loader_fn()):
        ids, mask = tokenize(sentences)
        ids = np.array(ids)
        ids[:, 0] = enc_token_id  # reference models/blip_nlvr.py:69
        images = torch.from_numpy(np.concatenate([image0, image1], axis=0))
        out = step(images.to(device),
                   torch.from_numpy(ids).to(device), torch.from_numpy(np.asarray(mask)).to(device),
                   temperature)
        if pending is not None:
            consume(pending)
        pending = (out, targets, ids.shape[1])
        if print_freq and i % print_freq == 0:
            print_fn(f"Evaluation: [{i}]")
    if pending is not None:
        consume(pending)
    cur_gflops = gflops_sum / max(n_batches, 1)
    print_fn(f"Current Temperature: {temperature}")
    print_fn(f"Averaged GFLOPS: {cur_gflops}")
    stats = {"acc": f"{correct / max(seen, 1):.4f}"}
    if capacities_v is not None and prune_active:
        stats["overflow"] = str(overflow)
    return stats, cur_gflops


def fast_capacity_schedule(vk, tk, cap_mode: str, *, margin_v: int = 16,
                           margin_t: int = 4):
    """Capacity schedules from mask-mode kept counts: vision at
    ``"nearest"``-128 or lossless ``"ceil"``-64, text at ceil-8.  ``tk=None``
    skips the text schedule."""
    vk = np.asarray(vk)
    cv = calibrate_capacities(
        vk if vk.ndim == 2 else vk[None, :], margin=margin_v,
        multiple=128 if cap_mode == "nearest" else 64, mode=cap_mode)
    if tk is None:
        return cv, None
    tk = np.asarray(tk)
    ct = calibrate_capacities(tk if tk.ndim == 2 else tk[None, :],
                              margin=margin_t, multiple=8)
    return cv, ct
