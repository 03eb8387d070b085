"""Data parallelism over processes: the global-batch scope of a train step
(the data-parallel half of ``madtp_tpu/parallel/mesh.py:24-120``).

Under the JAX package's global mesh a multi-process train step is the
one-device program on the *global* batch.  Two things of that program span
the ranks' rows, and :func:`global_batch` gives the port both:

* DTP's batch-coupled counts (``topk_num``, the largest alive count) are a
  max over every rank's rows: :func:`batch_max`, which
  ``prune/dtp.py`` ``_keep_rule`` calls;
* the gradient is the global loss's: :func:`reduce_step` sums each rank's
  gradients and logged losses weighted by the count its loss is a mean
  over, and divides by the global count;
* the retrieval and CLIP steps' rows of the other ranks (the contrastive
  loss's momentum features and ids, the hard negatives' candidates, the
  queue's batch): :func:`batch_rows` gives this rank's place in the global
  batch and :func:`world_rows` every rank's rows, with or without their
  gradient (the reference's ``all_gather_with_grad`` and
  ``concat_all_gather``).

Eval runs per rank, as the JAX package's does on each process's local mesh,
so outside the scope nothing communicates.  The scope is a process-wide
flag set only for the ``with`` block, not a thread-local: under remat the
backward recomputes a block's DTP on autograd's device thread, and that
recompute must take the same global counts as the forward did.  No
collective may enter a CUDA graph, so :func:`batch_max` and
:func:`world_rows` refuse to run in a capture.  Outside the scope every
helper is the identity: a one-process step is the same bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from madtp_tpu_torch.parallel import dist


class _Scope:
    active = False
    group = None  # the ranks :func:`batch_max` spans; None: every rank


_SCOPE = _Scope()


@contextlib.contextmanager
def global_batch(group=None):
    """The train steps run in this block span every rank's batch: DTP counts
    are maxed and gradients reduced over the ranks.  With one process it
    changes nothing.  ``group`` (a mesh's data group,
    :func:`madtp_tpu_torch.parallel.mesh.data_scope`): DTP's counts are maxed
    over its ranks only."""
    if group is None and dist.process_count() <= 1:
        yield
        return
    prev = _SCOPE.active, _SCOPE.group
    _SCOPE.active, _SCOPE.group = True, group
    try:
        yield
    finally:
        _SCOPE.active, _SCOPE.group = prev


def spans() -> bool:
    """Whether the current step spans the ranks."""
    return _SCOPE.active


def _not_captured(t: torch.Tensor, what: str) -> None:
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} inside a CUDA graph capture: collectives cannot be captured")


def batch_max(*counts: torch.Tensor) -> Sequence[torch.Tensor]:
    """Each 0-d integer count maxed over every rank in one ``all_reduce``
    inside :func:`global_batch`; the counts themselves outside it."""
    if not _SCOPE.active:
        return counts
    _not_captured(counts[0], "a global-batch DTP count")
    t = torch.stack([c.reshape(()).to(torch.int64) for c in counts])
    return tuple(dist.all_reduce(t, "max", _SCOPE.group).unbind(0))


def batch_rows(n: int) -> Tuple[int, int]:
    """``(offset, total)``: where this rank's ``n`` rows start in the global
    batch, and the global batch's rows, inside :func:`global_batch`; ``(0,
    n)`` outside it.  The steps that gather rows take the same count on
    every rank: the gradient of a row gathered from another rank comes back
    unweighted (:func:`world_rows`), while :func:`reduce_step` weights each
    rank by its count, and the two agree only at equal counts.  So unequal
    counts raise, on every rank; the drivers' ``drop_last`` gives equal
    ones, as the JAX package's sharded loader does.  The counts travel in
    one small host gather (under NCCL it waits for the card)."""
    if not _SCOPE.active:
        return 0, n
    counts = dist.host_allgather(np.asarray([n], np.int64))[:, 0]
    if (counts != n).any():
        raise ValueError(f"the ranks hold {counts.tolist()} rows: a step that gathers rows "
                         "across ranks needs the same count on every rank (drop_last)")
    return dist.process_index() * n, n * len(counts)


def world_rows(t: torch.Tensor, *, grad: bool = False) -> torch.Tensor:
    """Every rank's rows of ``t`` (equal counts, :func:`batch_rows`)
    concatenated in rank order inside :func:`global_batch`, ``t`` itself
    outside it.  ``grad``: the gradient of each rank's slice flows back to
    that rank, summed over every rank's loss (``all_gather_with_grad``, the
    reference's ``GatherLayer``); else the rows carry no gradient
    (``concat_all_gather``)."""
    if not _SCOPE.active:
        return t
    _not_captured(t, "a global-batch row gather")
    if grad:
        return dist.all_gather_with_grad(t)
    if t.dtype == torch.bool:
        return dist.concat_all_gather(t.view(torch.uint8)).view(torch.bool)
    return dist.concat_all_gather(t)


def reduce_step(params: Iterable[torch.nn.Parameter], metrics: Sequence[torch.Tensor],
                count) -> List[torch.Tensor]:
    """Turn this rank's gradients and metrics into the global batch's, in one
    ``all_reduce`` of a flat buffer in parameter order: each rank adds its
    gradients and metrics times ``count`` (the rows, tokens or questions its
    loss is a mean over; a Python number or a device scalar), and every rank
    divides the sums by the summed count (at least 1).  The gradients are
    written back in place; returns the global metrics.

    The parameters without a gradient must be the same on every rank: their
    number travels in the buffer and a mismatch raises."""
    grads = [p.grad for p in params if p.grad is not None]
    dev = metrics[0].device
    w = torch.as_tensor(count, dtype=torch.float32, device=dev).reshape(1)
    n = len(grads)
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [torch.stack([m.float() for m in metrics]).reshape(-1), w.new_ones(1)])
    flat.mul_(w)
    flat = dist.all_reduce(torch.cat([flat, w.new_full((1,), float(n))]), "sum")
    # checked on the device, so the step does not wait for the card here
    torch._assert_async(flat[-1] == n * dist.process_count(),
                        "ranks hold gradients for different parameters")
    total = flat[-2].clamp_min(1.0)
    off = 0
    for g in grads:
        k = g.numel()
        g.copy_((flat[off:off + k] / total).view_as(g))
        off += k
    return list((flat[off:off + len(metrics)] / total).unbind(0))
