"""Model reports and profiling (counterpart of ``madtp_tpu/utils/profiling.py:
21-84``, the reference's ``print_params_and_flops`` and MetricLogger's memory
probe):

* :func:`tree_param_counts` — parameters per top-level submodule;
* :func:`print_params_and_flops` — the task's unpruned analytic GFLOPs at
  its canned input sizes (:mod:`madtp_tpu_torch.prune.flops`);
* :func:`trace` — a ``torch.profiler`` context that writes a TensorBoard
  trace;
* :func:`device_memory_stats` — the card's allocator statistics.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Dict, Optional

import torch
from torch import nn


def tree_param_counts(model: nn.Module) -> Dict[str, int]:
    """Element counts of the parameters under each top-level name of
    ``model`` (a submodule, or a parameter such as ``space_dict``), and
    their ``"TOTAL"``."""
    out: Dict[str, int] = {}
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        out[top] = out.get(top, 0) + p.numel()
    out["TOTAL"] = sum(out.values())
    return out


def print_params_and_flops(task: str, cfg, *, text_len: int = 26, print_fn=print) -> float:
    """The startup report: the task's unpruned GFLOPs (the analytic model,
    fvcore's MAC convention) at the JAX package's canned shapes: NLVR and
    VQA ``text_len`` tokens, caption a 14-token decoder, retrieval 35
    tokens, CLIP its context.  ``task``: ``nlvr``, ``caption``, ``vqa``,
    ``retrieval`` or ``retrieval_clip``.  Returns the GFLOPs."""
    from madtp_tpu_torch.prune import flops as F

    if task == "nlvr":
        g = F.nlvr_gflops(cfg.vit, cfg.med, [cfg.vit.num_patches] * cfg.vit.depth,
                          [text_len - 1] * cfg.med.num_hidden_layers, text_len)
    elif task == "caption":
        g = F.caption_gflops(cfg.vit, cfg.med, [cfg.vit.num_patches] * cfg.vit.depth, 14)
    elif task == "vqa":
        g = F.vqa_gflops(cfg.vit, cfg.med, [cfg.vit.num_patches] * cfg.vit.depth,
                         [text_len - 1] * cfg.med.num_hidden_layers, text_len)
    elif task == "retrieval":
        g = F.retrieval_gflops(cfg.vit, cfg.med, [cfg.vit.num_patches] * cfg.vit.depth,
                               [34] * cfg.med.num_hidden_layers, 35)
    elif task == "retrieval_clip":
        g = F.clip_gflops(cfg, [cfg.vision_num_patches] * cfg.vision_layers,
                          [cfg.context_length - 1] * cfg.transformer_layers)
    else:
        raise ValueError(task)
    print_fn(f"[{task}] unpruned compute: {g:.2f} GFLOPs (analytic, fvcore-MAC convention)")
    return g


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``with trace(logdir):`` around device work profiles the host and,
    when a card is there, the card, and writes a TensorBoard trace under
    ``logdir`` (default ``madtp_trace`` in the temporary directory).
    Yields the directory."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "madtp_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield logdir


def device_memory_stats(device=None) -> Dict[str, float]:
    """The card's allocator statistics in MiB: ``bytes_in_use_mb`` (now)
    and ``peak_bytes_in_use_mb`` (since the last reset).  Raises without a
    card: there is no CPU answer."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_stats needs a CUDA device")
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0) / 2 ** 20,
            "peak_bytes_in_use_mb": stats.get("allocated_bytes.all.peak", 0) / 2 ** 20}
