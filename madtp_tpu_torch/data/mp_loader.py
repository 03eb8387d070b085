"""Process-worker batched loader (counterpart of ``madtp_tpu/data/mp_loader.py:1-288``;
the reference's DataLoader runs 4 worker processes, ``data/__init__.py:93-104``).

The threaded loader (:func:`madtp_tpu_torch.data.loader.batched_loader`)
decodes on threads, which serialize on Python-level transform work
(RandAugment's dispatch, numpy glue).  This loader forks worker processes
instead, keeps a bounded window of tasks in flight, reorders their results
by sequence number (the threaded loader's batch order, for the same
schedule), and hands large arrays back through a reused ring of shared-memory
slots.

* ``fork``: the datasets hold transform closures that do not pickle, and a
  forked worker inherits them.  A worker runs only numpy, ``zlib`` and the
  port's transforms, never a torch op: the parent may hold a CUDA context and
  torch's intra-op thread pool, neither of which survives ``fork``.
* Each in-flight batch owns a slot; its large columns go to named
  shared-memory segments created once per (worker, slot, column) and reused
  (a fresh mapping per batch costs page faults on every byte).  Segment
  names embed the worker's pid: slots move between workers, and a name
  shared by two workers would let one write into a segment the other had
  unlinked and recreated larger.  Small columns (ids, captions) are pickled
  onto the result queue.
* The consumer owns the segments: it unlinks every one when it stops, early
  or at the end.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import random
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Callable, Iterator

import numpy as np

from madtp_tpu_torch.data.loader import default_collate, shard_indices
from madtp_tpu_torch.data.transforms import fetch_with_ctx

_SHM_MIN_BYTES = 1 << 16  # smaller arrays ride the result queue
_MAX_COLUMNS = 16  # columns a batch may carry in shared memory


def segment_name(tag: str, pid: int, slot: int, col: int) -> str:
    return f"madtp{tag}_w{pid}_{slot}_{col}"


class _SlotWriter:
    """A worker's slot segments (``_SlotWriter``, ``mp_loader.py:43-91``):
    created at first use, reused, recreated larger when a batch outgrows
    one."""

    def __init__(self, tag: str):
        self.tag = tag
        self.segs: dict = {}  # (slot, col) -> SharedMemory

    def write(self, slot: int, col: int, arr: np.ndarray) -> tuple:
        name = segment_name(self.tag, os.getpid(), slot, col)
        seg = self.segs.get((slot, col))
        if seg is not None and seg.size < arr.nbytes:
            seg.close()
            seg = None
            shared_memory.SharedMemory(name=name).unlink()
        if seg is None:
            size = max(int(arr.nbytes), 1)
            try:
                seg = shared_memory.SharedMemory(name=name, create=True, size=size)
            except FileExistsError:
                seg = shared_memory.SharedMemory(name=name)
                if seg.size < arr.nbytes:
                    seg.close()
                    shared_memory.SharedMemory(name=name).unlink()
                    seg = shared_memory.SharedMemory(name=name, create=True, size=size)
            # the consumer unlinks; this worker's resource tracker must not
            # warn about (or unlink) the segment when the worker exits
            resource_tracker.unregister(seg._name, "shared_memory")
            self.segs[(slot, col)] = seg
        np.ndarray(arr.shape, arr.dtype, buffer=seg.buf)[...] = arr
        return ("shm", name, arr.shape, arr.dtype.str)

    def close(self):
        for seg in self.segs.values():
            seg.close()


def _worker(dataset, collate, task_q, result_q, tag, worker_seed, epoch):
    # Fork copies the parent's global random states into every worker:
    # reseed them per worker (as torch's DataLoader does).  PerSampleRng
    # transforms do not need it: fetch_with_ctx gives them the stream of
    # (seed, epoch, index) the threaded loader gives them.
    random.seed(worker_seed)
    np.random.seed(worker_seed % (2 ** 32))
    writer = _SlotWriter(tag)
    try:
        while True:
            item = task_q.get()
            if item is None:
                return
            seq, slot, idxs = item
            try:
                batch = collate([fetch_with_ctx(dataset, epoch, int(i)) for i in idxs])
                out = []
                for ci, col in enumerate(batch):
                    if isinstance(col, np.ndarray) and col.nbytes >= _SHM_MIN_BYTES:
                        out.append(writer.write(slot, ci, col))
                    else:
                        out.append(("obj", col))
                result_q.put((seq, slot, tuple(out), None))
            except Exception as e:  # noqa: BLE001 raised again by the consumer
                result_q.put((seq, slot, None, repr(e)))
    finally:
        writer.close()


class _SlotReader:
    """The consumer's attachments to the workers' segments."""

    def __init__(self):
        self.segs: dict = {}  # name -> SharedMemory

    def read(self, item):
        if item[0] == "obj":
            return item[1]
        _, name, shape, dtype = item
        seg = self.segs.get(name)
        need = np.dtype(dtype).itemsize * max(1, int(np.prod(shape)))
        if seg is None or seg.size < need:
            if seg is not None:
                seg.close()
            seg = shared_memory.SharedMemory(name=name)
            self.segs[name] = seg
        return np.array(np.ndarray(shape, np.dtype(dtype), buffer=seg.buf))

    def close_and_unlink(self):
        for seg in self.segs.values():
            seg.close()
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
        self.segs.clear()


def mp_batched_loader(dataset, batch_size: int, *, shuffle: bool = False, seed: int = 42,
                      epoch: int = 0, num_shards: int = 1, shard_id: int = 0,
                      drop_last: bool = False, num_workers: int = 4, prefetch: int = 4,
                      collate: Callable = default_collate, batch_range=None) -> Iterator:
    """:func:`~madtp_tpu_torch.data.loader.batched_loader` with worker
    processes: the same schedule, ``batch_range`` and batch order;
    ``num_workers + prefetch`` batches in flight, each in a reused
    shared-memory slot.  A worker's failure is raised to the consumer, and a
    dead worker is reported after a minute without results."""
    idx = shard_indices(len(dataset), shuffle=shuffle, seed=seed, epoch=epoch,
                        num_shards=num_shards, shard_id=shard_id, drop_last=drop_last)
    batches = [idx[i:i + batch_size] for i in range(0, len(idx), batch_size)]
    if drop_last:
        batches = [b for b in batches if len(b) == batch_size]
    if batch_range is not None:
        batches = batches[batch_range[0]:batch_range[1]]
    if not batches:
        return
    if num_workers <= 0:
        for b in batches:
            yield collate([fetch_with_ctx(dataset, epoch, int(i)) for i in b])
        return

    ctx = mp.get_context("fork")
    task_q, result_q = ctx.Queue(), ctx.Queue()
    tag = f"{os.getpid()}_{random.SystemRandom().randrange(1 << 30)}"
    # a stable mix of (seed, epoch, worker): Python's hash() is salted per process
    procs = [ctx.Process(target=_worker,
                         args=(dataset, collate, task_q, result_q, tag,
                               (seed * 1000003 + epoch * 9973 + w) & 0x7FFFFFFF, epoch),
                         daemon=True)
             for w in range(num_workers)]
    for p in procs:
        p.start()

    n_slots = num_workers + prefetch
    free_slots = list(range(n_slots))
    reader = _SlotReader()
    submitted = next_seq = received = 0
    done: dict = {}  # seq -> (slot, packed columns)
    try:
        while submitted < len(batches) and free_slots:
            task_q.put((submitted, free_slots.pop(), batches[submitted]))
            submitted += 1
        while next_seq < len(batches):
            while next_seq not in done:
                try:
                    seq, slot, packed, err = result_q.get(timeout=60.0)
                except queue_mod.Empty:
                    dead = [p.pid for p in procs if not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"loader worker(s) died: pids {dead}")
                    continue
                received += 1
                if err is not None:
                    raise RuntimeError(f"loader worker failed: {err}")
                done[seq] = (slot, packed)
            slot, packed = done.pop(next_seq)
            next_seq += 1
            batch = tuple(reader.read(item) for item in packed)
            # the slot's contents are copied out: hand it to the next task
            if submitted < len(batches):
                task_q.put((submitted, slot, batches[submitted]))
                submitted += 1
            else:
                free_slots.append(slot)
            yield batch
    finally:
        for _ in procs:
            task_q.put(None)
        deadline = time.monotonic() + 5.0
        pending = submitted - received  # results still to come
        while pending > 0 and time.monotonic() < deadline:
            try:
                result_q.get(timeout=0.5)
            except queue_mod.Empty:
                continue
            pending -= 1
        for p in procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2.0)
        reader.close_and_unlink()
        # the segments this consumer never attached
        for p in procs:
            for slot in range(n_slots):
                for col in range(_MAX_COLUMNS):
                    try:
                        shared_memory.SharedMemory(
                            name=segment_name(tag, p.pid, slot, col)).unlink()
                    except FileNotFoundError:
                        pass
        task_q.close()
        result_q.close()
