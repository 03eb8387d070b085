"""The multi-process runtime over ``torch.distributed`` (counterpart of
``madtp_tpu/parallel/dist.py:26-147``).

A run of N processes has one process per card, on one host: rank ``r`` runs
on ``cuda:{r % device_count}``.  :func:`init_from_args` reads the JAX
drivers' flags (``--num_processes``, ``--process_id``, ``--coordinator``,
with ``MADTP_NUM_PROCESSES`` / ``MADTP_PROCESS_ID`` / ``MADTP_COORDINATOR``
behind them) and ``--dist_backend``: ``auto`` is NCCL on the card and gloo
on the CPU.  NCCL cannot run two ranks of one group on one card, so more
ranks than cards need ``--dist_backend gloo``.

The helpers keep the JAX names.  With one process each is the identity that
JAX's is: without a process group it returns at once, and a one-rank group's
collectives, which the helpers then run, give the same.  The host helpers
(:func:`host_allgather`, :func:`host_sum`, :func:`merge_scores`) take and
return numpy arrays and communicate on the backend's device (the CPU under
gloo, the rank's card under NCCL); the tensor helpers
(:func:`concat_all_gather`, :func:`all_gather_with_grad`,
:func:`all_gather_rows`, :func:`all_reduce`) communicate on the tensor's own
device.  Under gloo on the card that works for every collective used here:
on torch 2.11+cu128, gloo took CUDA tensors in ``all_reduce`` (SUM and MAX,
int64, fp32, fp64), ``all_gather``, ``all_gather_into_tensor``,
``broadcast`` and ``barrier``, so nothing is staged through the host.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as tdist

DEFAULT_COORDINATOR = "127.0.0.1:29500"
BACKENDS = ("auto", "nccl", "gloo")


def requested_processes(args) -> int:
    """The process count the command line or ``MADTP_NUM_PROCESSES`` asks for
    (0 or 1: one process)."""
    return int(getattr(args, "num_processes", 0)
               or os.environ.get("MADTP_NUM_PROCESSES", 0) or 0)


def init_from_args(args, device: torch.device) -> torch.device:
    """Join the process group the arguments describe and return this rank's
    device: ``device`` itself with one process, else the CPU or
    ``cuda:{rank % device_count}``.  Calling it again in a process that
    already joined the same group (several drivers' ``main`` in one
    process) returns the device without a second bring-up."""
    n = requested_processes(args)
    if n <= 1:
        return device
    pid = getattr(args, "process_id", -1)
    if pid is None or pid < 0:
        pid = int(os.environ.get("MADTP_PROCESS_ID", 0))
    if not 0 <= pid < n:
        raise ValueError(f"--process_id {pid} is outside [0, {n})")
    coord = (getattr(args, "coordinator", "") or os.environ.get("MADTP_COORDINATOR", "")
             or DEFAULT_COORDINATOR)
    backend = getattr(args, "dist_backend", "auto")
    if backend == "auto":
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("--dist_backend nccl needs the card; the CPU runs gloo")
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and n > cards:
            raise RuntimeError(
                f"--num_processes {n} over {cards} card(s): NCCL cannot run two ranks of one "
                "group on one card; pass --dist_backend gloo to share a card")
        device = torch.device("cuda", pid % cards)
        torch.cuda.set_device(device)
    if tdist.is_initialized():
        have = (tdist.get_world_size(), tdist.get_rank(), tdist.get_backend())
        if have != (n, pid, backend):
            raise RuntimeError(f"this process already joined a group (world, rank, backend) "
                               f"= {have}, not {(n, pid, backend)}")
        return device
    tdist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=n, rank=pid)
    print(f"distributed: process {pid}/{n} via {coord} ({backend}, {device})", flush=True)
    return device


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0: the one that merges results and writes logs and checkpoints."""
    return process_index() == 0


def reference_row_shard(n: int, num: int | None = None,
                        rank: int | None = None) -> Tuple[int, int]:
    """The reference's eval row sharding (``compress_retrieval_dtp.py:
    160-164``): ``step = n // num + 1``, rows ``[rank * step, min(n, rank *
    step + step))``.  A shard can be empty, or start past its end (read as
    empty), when ``num`` is large against ``n``."""
    num = process_count() if num is None else num
    rank = process_index() if rank is None else rank
    step = n // num + 1
    start = rank * step
    return start, min(n, start + step)


def _backend_device() -> torch.device:
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "madtp_barrier") -> None:
    """Every rank waits here for the others (the reference's
    ``dist.barrier()`` between the per-rank result writes and the rank-0
    merge).  ``name`` only labels the call site, as JAX's does."""
    if not tdist.is_initialized():
        return
    if tdist.get_backend() == "nccl":
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()


def _gather_list(t: torch.Tensor) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(process_count())]
    tdist.all_gather(out, t.contiguous())
    return out


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` with ``op`` (``"sum"`` or ``"max"``)
    over every rank, or over the ranks of ``group`` (a mesh axis,
    :mod:`madtp_tpu_torch.parallel.mesh`); returns ``t``."""
    if tdist.is_initialized():
        tdist.all_reduce(t, op={"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}[op],
                         group=group)
    return t


def host_allgather(x) -> np.ndarray:
    """Every rank's host array ``x`` (the same shape and dtype on all of them)
    stacked in rank order: ``[P, *x.shape]``."""
    a = np.ascontiguousarray(np.asarray(x))
    if not tdist.is_initialized():
        return a[None]
    boolean = a.dtype == np.bool_
    t = torch.from_numpy(a.view(np.uint8) if boolean else a).to(_backend_device())
    out = torch.stack(_gather_list(t)).cpu().numpy()
    return out.view(np.bool_) if boolean else out


def host_sum(x) -> np.ndarray:
    """The elementwise sum of every rank's host array, added in rank order on
    the host (the reference's ``dist.all_reduce(SUM)``)."""
    return host_allgather(x).sum(axis=0)


def merge_scores(x) -> np.ndarray:
    """Every rank's row-sharded score matrix, initialized at -100, merged by
    :func:`~madtp_tpu_torch.tasks.retrieval.merge_score_matrices` (a
    sentinel select: each entry was written by at most one rank)."""
    from madtp_tpu_torch.tasks.retrieval import merge_score_matrices

    return merge_score_matrices(*host_allgather(x))


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``t`` (their counts may differ, their trailing
    shapes may not) concatenated in rank order, on ``t``'s device: the rows
    are padded to the largest count for the gather and the padding dropped."""
    if not tdist.is_initialized():
        return t
    counts = host_allgather(np.asarray([t.shape[0]], np.int64))[:, 0]
    pad = int(counts.max()) - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    parts = _gather_list(t.view(torch.uint8) if t.dtype == torch.bool else t)
    out = torch.cat([p[:c] for p, c in zip(parts, counts)])
    return out.view(torch.bool) if t.dtype == torch.bool else out


def concat_all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order, with no
    gradient (reference ``models/blip_retrieval.py:334-345``)."""
    if not tdist.is_initialized():
        return x.detach()
    return torch.cat(_gather_list(x.detach()))


class _GatherLayer(torch.autograd.Function):
    """The reference's ``GatherLayer`` (``models/blip_retrieval.py:
    348-380``): forward an ``all_gather``; backward the SUM of every rank's
    gradient of the gathered tensors, of which this rank keeps its slice."""

    @staticmethod
    def forward(ctx, x):
        return tuple(_gather_list(x))

    @staticmethod
    def backward(ctx, *grads):
        g = all_reduce(torch.stack(grads).contiguous(), "sum")
        return g[process_index()]


def all_gather_with_grad(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order, with the
    gradient of each slice flowing back to the rank that gave it."""
    if not tdist.is_initialized():
        return x
    return torch.cat(_GatherLayer.apply(x))
