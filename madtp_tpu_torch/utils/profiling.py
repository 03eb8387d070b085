"""Model reports and profiling (counterpart of ``madtp_tpu/utils/profiling.py:
21-84``, the reference's ``print_params_and_flops`` and MetricLogger's memory
probe):

* :func:`tree_param_counts` — parameters per top-level submodule;
* :func:`print_params_and_flops` — the task's unpruned analytic GFLOPs at
  its canned input sizes (:mod:`madtp_tpu_torch.prune.flops`);
* :func:`trace` — a ``torch.profiler`` context that writes a TensorBoard
  trace;
* :func:`span`, :func:`count`, :func:`records`, :func:`span_ms`,
  :func:`clear` — the program's own spans and counters, kept while a
  profiler records;
* :func:`device_memory_stats` — the card's allocator statistics.

Spans and counters.  The host phases of the eval loops, the captured steps
and the train step are :func:`span` s (``feed``, ``dispatch``,
``forward``, ``backward``, ``optimizer``, ``readback``, ``rank``); the
train step's kept counts (``kept.vision``, ``kept.text``) and each replay
and capture of a CUDA graph (``graph.replay``, ``graph.capture``, the
step's name) are :func:`count` s.  They record exactly while a ``torch.profiler`` records
(:func:`trace`, or any ``torch.profiler.profile``): then each span is also a
``record_function`` range of the same name, so it shows in the trace, and
each leaves a record (:func:`records`) whose start and end are on the
clock of the profiler's events, so an idle gap of the device can be put
down to the span the host was in.  Otherwise a span or a counter reads the
profiler's flag and does nothing else.  Nothing is recorded while a CUDA
graph is captured.  The records are a ring of :data:`MAX_RECORDS`, the
oldest dropped (:func:`dropped`); :func:`clear` empties it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

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
    Yields the directory.  The program's spans show in the trace as ranges
    of their names, and its spans and counters are kept meanwhile
    (:func:`records`)."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "madtp_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield logdir


MAX_RECORDS = 65536

# True exactly while a profiler records (the profiler's own flag)
_profiling = torch._C._autograd._profiler_enabled
# kineto stamps its events with the Unix clock in ns
_clock = time.time_ns
_ring: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count()
_dropped = [0]
_local = threading.local()


def _recording() -> bool:
    """A profiler records, and no CUDA graph is being captured."""
    return _profiling() and not (torch.cuda.is_initialized()
                                 and torch.cuda.is_current_stream_capturing())


def _open() -> list:
    """The calling thread's open spans, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _keep(rec: tuple) -> None:
    if len(_ring) == MAX_RECORDS:
        _dropped[0] += 1
    _ring.append(rec)


class _Span:
    __slots__ = ("name", "item", "id", "parent", "start", "range")

    def __init__(self, name: str, item):
        self.name, self.item = name, item

    def __enter__(self):
        stack = _open()
        self.id, self.parent = next(_ids), stack[-1] if stack else None
        stack.append(self.id)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        # read after the range's own stamp: the host's stalls inside the
        # enter mostly come before that stamp
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        end = _clock()
        _open().pop()
        _keep(("span", self.id, self.name, self.item, self.parent, self.start, end))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, item=None):
    """``with span(name, item):`` around a host phase of the program: while
    a profiler records, a ``record_function`` range and a record of the
    phase (``item``: the batch or step index, where the loop has one);
    otherwise nothing."""
    return _Span(name, item) if _recording() else _OFF


def count(name: str, value, item=None) -> None:
    """Keep ``value`` (a number, a list or a tensor, held as given: a device
    tensor is read only by :func:`records`) under ``name`` while a profiler
    records; otherwise nothing."""
    if _recording():
        stack = _open()
        _keep(("count", next(_ids), name, item, stack[-1] if stack else None, _clock(), value))


def records() -> List[dict]:
    """The records kept, in the order they opened.  A span's: ``kind``
    ``"span"``, ``id``, ``name``, ``item``, ``parent`` (the ``id`` of the
    span open around it, or None), ``start_ns`` and ``end_ns`` (the
    profiler's clock) and ``self_ns`` (its time less the time of the spans
    directly inside it).  A counter's: ``kind`` ``"count"``, ``id``,
    ``name``, ``item``, ``parent``, ``at_ns`` and ``value`` (a tensor as a
    list or a number)."""
    held = sorted(_ring, key=lambda r: r[1])
    inner: Dict[int, int] = {}
    for r in held:
        if r[0] == "span" and r[4] is not None:
            inner[r[4]] = inner.get(r[4], 0) + r[6] - r[5]
    out = []
    for kind, rid, name, item, parent, t, x in held:
        rec = dict(kind=kind, id=rid, name=name, item=item, parent=parent)
        if kind == "span":
            rec.update(start_ns=t, end_ns=x, self_ns=x - t - inner.get(rid, 0))
        else:
            rec.update(at_ns=t, value=x.tolist() if torch.is_tensor(x) else x)
        out.append(rec)
    return out


def span_ms(name: str, self_time: bool = False) -> List[float]:
    """The times in ms (``self_time``: the self times) of the kept spans
    named ``name`` that lie in no other span of that name, in the order
    they opened."""
    held = records()
    by_id = {r["id"]: r for r in held if r["kind"] == "span"}

    def outermost(r):
        p = r["parent"]
        while p is not None and p in by_id:
            if by_id[p]["name"] == name:
                return False
            p = by_id[p]["parent"]
        return True
    return [(r["self_ns"] if self_time else r["end_ns"] - r["start_ns"]) / 1e6
            for r in by_id.values() if r["name"] == name and outermost(r)]


def dropped() -> int:
    """Records dropped from the full ring since the last :func:`clear`."""
    return _dropped[0]


def clear() -> None:
    """Empty the records and the count of drops."""
    _ring.clear()
    _dropped[0] = 0


def device_memory_stats(device=None) -> Dict[str, float]:
    """The card's allocator statistics in MiB: ``bytes_in_use_mb`` (now)
    and ``peak_bytes_in_use_mb`` (since the last reset).  Raises without a
    card: there is no CPU answer."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_stats needs a CUDA device")
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0) / 2 ** 20,
            "peak_bytes_in_use_mb": stats.get("allocated_bytes.all.peak", 0) / 2 ** 20}
