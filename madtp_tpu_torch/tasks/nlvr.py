"""NLVR2 evaluation and compression training
(counterpart of ``madtp_tpu/tasks/nlvr.py:27-257``): the eval step, the
eval loop that returns the analytic per-sample GFLOPs (each rank's shard,
its totals summed over the ranks), the train epoch (each step over the
global batch of all ranks), and the ``--fast_train`` capacity probe
(``madtp_tpu/cli/compress_nlvr.py:270-300``).  ``fast_capacity_schedule``
lives in :mod:`madtp_tpu_torch.prune.calibrate` and is importable from here
too."""

from __future__ import annotations

import itertools
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from madtp_tpu_torch.models.blip import NLVRModel, NLVROut
from madtp_tpu_torch.parallel import data, dist
from madtp_tpu_torch.prune.calibrate import fast_capacity_schedule
from madtp_tpu_torch.prune.flops import nlvr_gflops
from madtp_tpu_torch.train.epoch import run_epoch
from madtp_tpu_torch.utils.graph import CapturedStep


def make_eval_step(model: NLVRModel, prune_active: bool,
                   capacities_v: Optional[Sequence[int]] = None,
                   capacities_t: Optional[Sequence[int]] = None, *, graph: bool = True,
                   row_independent: bool = False):
    """``step(images, ids, mask, temperature) -> NLVROut`` without autograd;
    capacities select gather mode, ``row_independent`` per-row DTP (the
    serving mode: kept counts ``[L, 2B]`` and ``[L, B]``).  The step is
    captured (:class:`~madtp_tpu_torch.utils.graph.CapturedStep`: one CUDA
    graph per mode, capacities, row independence and input shape, the
    temperature an input of it); ``graph=False`` runs it eagerly."""
    @torch.inference_mode()
    def step(images, ids, mask, temperature) -> NLVROut:
        return model(images, ids.long(), mask, temperature=temperature,
                     prune_active=prune_active, capacities_v=capacities_v,
                     capacities_t=capacities_t, row_independent=row_independent)
    if not graph:
        return step
    return CapturedStep(step, "nlvr_eval", model,
                        static=(prune_active, capacities_v, capacities_t, row_independent))


def _device_batch(image0, image1, sentences, tokenize, enc_token_id, device):
    """Images ``[2B, ...]`` (first images, then second ones), ids with the
    encoder token at slot 0 (reference ``models/blip_nlvr.py:69``) and the
    mask, on ``device``; returns them and the text length."""
    ids, mask = tokenize(sentences)
    ids = np.array(ids)
    ids[:, 0] = enc_token_id
    images = torch.from_numpy(np.concatenate([image0, image1], axis=0))
    return (images.to(device), torch.from_numpy(ids).to(device),
            torch.from_numpy(np.asarray(mask)).to(device)), ids.shape[1]


def evaluate(model: NLVRModel, loader_fn: Callable[[], Iterable], tokenize,
             temperature: float, *, prune_active: bool, enc_token_id: int,
             capacities_v=None, capacities_t=None, print_fn=print,
             print_freq: int = 50, graph: bool = True) -> Tuple[dict, float]:
    """Returns ``(stats, Cur_Gflops)``.  ``loader_fn()`` yields
    ``(image0, image1, sentences, targets)`` numpy batches; ``tokenize`` maps
    the sentences to numpy ``(ids, mask)``.  Batch ``i+1`` is dispatched
    before batch ``i`` is read back, so the card does not wait on the host
    loop.  ``stats`` holds the accuracy and, in gather mode, the overflow
    count summed over batches.  Each batch runs as a captured step
    (``graph=False``: eagerly).  Under several processes each rank
    evaluates its own loader's shard and every rank returns the totals over
    all of them."""
    cfg = model.cfg
    device = model.space_dict.device
    step = make_eval_step(model, prune_active, capacities_v, capacities_t, graph=graph)
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
        batch, text_w = _device_batch(image0, image1, sentences, tokenize, enc_token_id,
                                      device)
        out = step(*batch, temperature)
        if pending is not None:
            consume(pending)
        pending = (out, targets, text_w)
        if print_freq and i % print_freq == 0:
            print_fn(f"Evaluation: [{i}]")
    if pending is not None:
        consume(pending)
    if dist.process_count() > 1:
        # each rank evaluated its own shard: every rank reports the totals
        # (``madtp_tpu/tasks/nlvr.py:155-170``)
        tot = dist.host_sum(np.asarray([correct, seen, gflops_sum, n_batches, overflow],
                                       np.float64))
        correct, seen, n_batches, overflow = (int(tot[i]) for i in (0, 1, 3, 4))
        gflops_sum = float(tot[2])
    cur_gflops = gflops_sum / max(n_batches, 1)
    print_fn(f"Current Temperature: {temperature}")
    print_fn(f"Averaged GFLOPS: {cur_gflops}")
    stats = {"acc": f"{correct / max(seen, 1):.4f}"}
    if capacities_v is not None and prune_active:
        stats["overflow"] = str(overflow)
    return stats, cur_gflops


def train_epoch(model: NLVRModel, train_step, loader_fn: Callable[[], Iterable], tokenize,
                enc_token_id: int, temperature: float, *, print_fn=print,
                print_freq: int = 50, lr: float = 0.0, stop=None) -> dict:
    """One compression-training epoch (under several processes each step
    spans the ranks: :func:`~madtp_tpu_torch.parallel.data.global_batch`).  ``train_step`` is
    :func:`madtp_tpu_torch.train.loops.make_nlvr_train_step`'s step, which
    updates the model in place.  Step ``i``'s losses are read back after
    step ``i+1`` is dispatched (a one-deep lag), so the host does not wait
    on the card every step.  ``stop()`` is polled after each step, so a
    stopped epoch counts every batch it trained exactly once.

    Returns the stats: the mean of ``temperature``, ``lr``, ``loss``,
    ``loss_ori`` and ``loss_fdt`` as ``"%.4f"`` strings, and
    ``batches_done`` (int)."""
    device = model.space_dict.device

    def run_step(_, batch):
        image0, image1, sentences, targets = batch
        x, _ = _device_batch(image0, image1, sentences, tokenize, enc_token_id, device)
        return train_step(*x, torch.from_numpy(np.asarray(targets)).to(device), temperature)

    with data.global_batch():  # under several processes each step spans the ranks
        return run_epoch(loader_fn(), run_step, temperature, lr=lr, print_fn=print_fn,
                         print_freq=print_freq, stop=stop)


def cached_probe_batches(cache: list, loader_factory: Callable[[], Iterable],
                         n: int = 2) -> List:
    """Pull ``n`` probe batches once and keep them in ``cache`` (a
    one-element ``[None]`` list the caller owns), so every epoch's
    ``--fast_train`` calibration reads the same batches."""
    if cache[0] is None:
        it = loader_factory()
        cache[0] = list(itertools.islice(it, n))
        close = getattr(it, "close", None)
        if close is not None:
            close()
        if not cache[0]:
            raise ValueError("probe loader yielded no batches")
    return cache[0]


def probe_capacities(model: NLVRModel, batches, tokenize, enc_token_id: int,
                     temperature: float, cap_mode: str = "ceil"):
    """``--fast_train``'s per-epoch calibration (``fast_train_step`` in
    ``madtp_tpu/cli/compress_nlvr.py:270-300``): the
    mask-mode eval step on the probe batches at this epoch's temperature,
    then :func:`fast_capacity_schedule` over their kept counts.  Returns
    ``(capacities_v, capacities_t)``."""
    device = model.space_dict.device
    probe = make_eval_step(model, prune_active=True, graph=False)
    vks, tks = [], []
    for image0, image1, sentences, _ in batches:
        batch, _ = _device_batch(image0, image1, sentences, tokenize, enc_token_id, device)
        out = probe(*batch, temperature)
        vks.append(out.v_kept.cpu().numpy())
        tks.append(out.t_kept.cpu().numpy())
    return fast_capacity_schedule(np.stack(vks), np.stack(tks), cap_mode)
