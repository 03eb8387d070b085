"""Captured steps: each eval step as one CUDA graph, replayed with one launch
from the host (the counterpart of ``jax.jit`` and of the JAX package's step
caches keyed by capacities, ``madtp_tpu/tasks/nlvr.py:24-76``).

A :class:`CapturedStep` wraps ``fn(*inputs)``: a step whose inputs are
tensors, Python numbers or ``None`` and whose output is a tensor, ``None``
or a (named) tuple of them.  Its entries are keyed as the JAX package's step
caches are, by the step's name and its static arguments (prune mode,
capacities, beam settings), at most 8 of them, least recently used dropped.
Within an entry, as ``jax.jit`` keeps a program for every input shape it
has seen, there is one graph for each signature of the inputs (each
input's shape, dtype and device; a number counts as a 0-d float32 tensor),
with its static input buffers.  The graphs of one entry share one memory
pool: they replay one at a time on one stream and each call clones its
outputs before the next replay, so one graph's scratch may be another's.

* a call copies its inputs into the buffers (a number by a fill kernel: the
  temperature is an input of the graph, not a constant in it, so one capture
  serves every temperature, as ``t`` does under ``jax.jit``), replays the
  graph and returns clones of its outputs.  The next replay overwrites the
  graph's own outputs, and the eval loops dispatch batch ``i+1`` before they
  read batch ``i``;
* a new signature runs ``fn`` once on its buffers on a side stream, the
  warm-up (the kernels' build and their first-use attributes, cuBLAS's
  handles), whose outputs are the call's result, then captures ``fn`` under
  ``torch.cuda.set_sync_debug_mode("error")``.  A step that waits on the
  card fails to capture and raises with its name; it is not cached, and
  nothing runs eagerly in its place;
* on the CPU there is no graph: the same buffers go through ``fn`` eagerly,
  the plain version that the tests hold against the JAX package.

A graph reads the weights by address, so it belongs to its model: the
entries are kept on the model (:func:`model_cache`), a ``load_state_dict``
that copies in place is seen by the next replay, and the entries are dropped
once a parameter or buffer no longer lies where the graphs read it (``.to()``,
a tensor replaced).  A step whose ``fn`` reads other tensors by address keeps
its entries in a cache of its own, which must not outlive them (the
rerank's resident corpus).

Launch counts: a kernel wrapper counts a launch when it enqueues its kernel.
During a capture the launch is recorded into the graph and does not run, so
the capture's counts are taken back and every replay adds them again: the
counts stay those of the kernels that ran.  ``CapturedStep.captures`` counts
the graphs captured and ``CapturedStep.capture_seconds`` the host's time in
their warm-ups and captures."""

from __future__ import annotations

import itertools
import time
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.nn.modules import module as _module

from madtp_tpu_torch.utils.cache import BoundedCache

MAXSIZE = 8  # entries kept per model, as the JAX package's step caches

# Bumped whenever any module registers a parameter, buffer or submodule: a
# tensor that replaced another is not in a model's list of weights.
_registrations = [0]


def _registered(*_):
    _registrations[0] += 1


_module.register_module_parameter_registration_hook(_registered)
_module.register_module_buffer_registration_hook(_registered)
_module.register_module_module_registration_hook(_registered)


def _counters() -> Tuple[Tuple[Callable, str], ...]:
    """Every launch counter of the kernel wrappers, as (wrapper, attribute)."""
    from madtp_tpu_torch.kernels.attention_scores import attention_scores_cuda
    from madtp_tpu_torch.kernels.attention_scores_bwd import attention_scores_bwd_cuda
    from madtp_tpu_torch.kernels.cross_attention import cross_attention_cuda
    from madtp_tpu_torch.kernels.ffn import ffn_cuda

    return ((attention_scores_cuda, "launches"), (attention_scores_cuda, "large_n_launches"),
            (attention_scores_bwd_cuda, "launches"), (cross_attention_cuda, "launches"),
            (ffn_cuda, "launches"), (ffn_cuda, "fp32_launches"))


class _Weights:
    """A model's parameters and buffers, where they lay when its graphs were
    captured, and the graphs' cache."""

    def __init__(self, model: nn.Module):
        self.registrations = _registrations[0]
        self.tensors = list(itertools.chain(model.parameters(), model.buffers()))
        self.addrs = [t.data_ptr() for t in self.tensors]
        self.steps = BoundedCache(maxsize=MAXSIZE)


def model_cache(model: nn.Module) -> BoundedCache:
    """The captured steps of ``model``: a new, empty cache once any of its
    parameters or buffers no longer lies where the graphs read it.  A call
    reads the addresses of the weights it listed; it lists them anew (a
    walk over the model) only after a module somewhere registered a
    tensor."""
    held = model.__dict__.get("_captured_steps")
    if held is not None and held.registrations != _registrations[0]:
        fresh = _Weights(model)
        if fresh.addrs == held.addrs:
            fresh.steps = held.steps
        held = model.__dict__["_captured_steps"] = fresh
    elif held is None or [t.data_ptr() for t in held.tensors] != held.addrs:
        held = model.__dict__["_captured_steps"] = _Weights(model)
    return held.steps


def graph_count(cache: BoundedCache) -> int:
    """The graphs (on the CPU: the signatures) held by a step cache."""
    return sum(len(step.entries) for step in cache.values())


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def _signature(x):
    if torch.is_tensor(x):
        return (tuple(x.shape), x.dtype, x.device)
    if _is_number(x):
        return "scalar"
    if x is None:
        return None
    raise TypeError(f"a captured step takes tensors, numbers and None, got {type(x).__name__}")


def _load(buf, x) -> None:
    if torch.is_tensor(x):
        buf.copy_(x)
    elif x is not None:
        buf.fill_(x)


def _clone(out):
    if torch.is_tensor(out):
        return out.clone()
    if isinstance(out, tuple):
        items = [_clone(v) for v in out]
        return type(out)(*items) if hasattr(out, "_fields") else tuple(items)
    return out


def _tensors(out):
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, tuple):
        for v in out:
            yield from _tensors(v)


class _Step:
    """One entry: the graphs of one step and static key, by input
    signature, their memory pool and the stream they are captured on."""

    def __init__(self):
        self.entries = {}
        self.pool = self.stream = self.last = None


class _Entry:
    """The static input buffers of one signature and, on the card, the
    graph of one call of the step on them, its outputs and the launches it
    holds."""

    def __init__(self, inputs: tuple):
        self.device = next(x.device for x in inputs if torch.is_tensor(x))
        self.buffers = tuple(
            torch.empty_like(x) if torch.is_tensor(x)
            else torch.empty((), dtype=torch.float32, device=self.device) if _is_number(x)
            else None for x in inputs)
        self.graph, self.out, self.launches = None, None, ()

    def capture(self, fn: Callable, name: str, step: _Step, inputs: tuple):
        """The warm-up's outputs, after capturing ``fn`` into ``step``'s pool."""
        t0 = time.perf_counter()
        for buf, x in zip(self.buffers, inputs):
            _load(buf, x)
        counters = _counters()
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream()
            if step.stream is None:
                step.stream = torch.cuda.Stream()
            step.stream.wait_stream(current)
            with torch.cuda.stream(step.stream):
                first = _clone(fn(*self.buffers))
                before = [getattr(f, a) for f, a in counters]
                graph = torch.cuda.CUDAGraph()
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    graph.capture_begin(*(() if step.pool is None else (step.pool,)))
                    try:
                        out = fn(*self.buffers)
                    finally:
                        graph.capture_end()
                except RuntimeError as err:
                    raise RuntimeError(f"the step {name!r} could not be captured as a CUDA "
                                       f"graph: {err}") from err
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
                    recorded = [getattr(f, a) - n for (f, a), n in zip(counters, before)]
                    for (f, a), n in zip(counters, before):
                        setattr(f, a, n)
            current.wait_stream(step.stream)
            for t in _tensors(first):
                t.record_stream(current)
        if step.pool is None:
            step.pool = graph.pool()
        self.graph, self.out = graph, out
        self.launches = tuple((c, n) for c, n in zip(counters, recorded) if n)
        CapturedStep.captures += 1
        CapturedStep.capture_seconds += time.perf_counter() - t0
        return first

    def run(self, fn: Callable, inputs: tuple):
        for buf, x in zip(self.buffers, inputs):
            _load(buf, x)
        if self.graph is None:
            return _clone(fn(*self.buffers))
        self.graph.replay()
        for (f, a), n in self.launches:
            setattr(f, a, getattr(f, a) + n)
        return _clone(self.out)


class CapturedStep:
    """``fn`` as a captured step named ``name`` (see the module's doc).
    ``static`` holds the arguments ``fn`` closes over that change its graph
    (prune mode, capacity tuples, beam settings), hashable as a cache key;
    the entries live in ``model_cache(owner)`` unless ``cache`` is given."""

    captures = 0  # graphs captured, all steps
    capture_seconds = 0.0  # host time of their warm-ups and captures

    def __init__(self, fn: Callable, name: str, owner: nn.Module, static=(),
                 cache: Optional[BoundedCache] = None):
        self.fn, self.name, self.owner, self.static, self.cache = fn, name, owner, static, cache

    @torch.inference_mode()
    def __call__(self, *inputs):
        cache = model_cache(self.owner) if self.cache is None else self.cache
        key = (self.name, self.static)
        step = cache[key] if key in cache else _Step()
        signature = tuple(_signature(x) for x in inputs)
        entry = step.entries.get(signature)
        if entry is not None:
            out = entry.run(self.fn, inputs)
        else:
            entry = _Entry(inputs)
            if entry.device.type == "cuda":
                out = entry.capture(self.fn, self.name, step, inputs)
            else:
                out = entry.run(self.fn, inputs)
            step.entries[signature] = entry
            cache[key] = step
        step.last = entry
        return out
