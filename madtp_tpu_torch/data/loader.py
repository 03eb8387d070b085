"""Batched loader with sharding and threaded prefetch (counterpart of
``madtp_tpu/data/loader.py:20-215``): a ``DistributedSampler``-style index
schedule, worker threads that decode ahead of the card, and the same batch
order whatever the thread count; ``MADTP_MP_LOADER=1`` routes it through the
process-worker loader of :mod:`madtp_tpu_torch.data.mp_loader`.
:func:`device_prefetch` keeps batches on the card ahead of their consumer."""

from __future__ import annotations

import collections
import os
import queue as queue_mod
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch

from madtp_tpu_torch.data.transforms import fetch_with_ctx


def shard_indices(n: int, *, shuffle: bool, seed: int, epoch: int,
                  num_shards: int = 1, shard_id: int = 0,
                  drop_last: bool = False) -> np.ndarray:
    """The index schedule: an optional shuffle seeded by ``seed + epoch``,
    padded to a multiple of ``num_shards``, strided over the shards."""
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(idx)
    if drop_last:
        idx = idx[: (n // num_shards) * num_shards]
    else:
        pad = (-len(idx)) % num_shards
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
    return idx[shard_id::num_shards]


def num_batches(n: int, batch_size: int, *, num_shards: int = 1,
                drop_last: bool = False) -> int:
    """Batches per shard of :func:`batched_loader`'s schedule."""
    if drop_last:
        return (n // num_shards) // batch_size
    per_shard = -(-n // num_shards)
    return -(-per_shard // batch_size)


def default_collate(batch):
    out = []
    for i in range(len(batch[0])):
        col = [b[i] for b in batch]
        if isinstance(col[0], np.ndarray):
            out.append(np.stack(col))
        elif isinstance(col[0], (int, np.integer)):
            out.append(np.asarray(col))
        elif isinstance(col[0], float):
            out.append(np.asarray(col, np.float32))
        else:
            out.append(col)
    return tuple(out)


def batched_loader(dataset, batch_size: int, *, shuffle: bool = False, seed: int = 42,
                   epoch: int = 0, num_shards: int = 1, shard_id: int = 0,
                   drop_last: bool = False, num_workers: int = 8,
                   collate: Callable = default_collate, prefetch: int = 4,
                   batch_range=None) -> Iterator:
    """Yields collated batches; items are fetched on ``num_workers`` threads
    (none: in line) with ``prefetch`` batches in flight.  ``batch_range=(lo,
    hi)`` keeps that slice of the batch schedule without fetching the
    batches before it.  A failed fetch is raised to the consumer; a consumer
    that stops early unblocks and ends the producer thread.

    With ``MADTP_MP_LOADER`` set and ``num_workers > 0`` the batches come
    from :func:`~madtp_tpu_torch.data.mp_loader.mp_batched_loader` on up to
    ``num_workers`` processes (no more than the host's cores): the same
    batches in the same order."""
    if os.environ.get("MADTP_MP_LOADER") and num_workers > 0:
        from madtp_tpu_torch.data.mp_loader import mp_batched_loader

        yield from mp_batched_loader(
            dataset, batch_size, shuffle=shuffle, seed=seed, epoch=epoch,
            num_shards=num_shards, shard_id=shard_id, drop_last=drop_last,
            num_workers=min(num_workers, os.cpu_count() or 1), prefetch=prefetch,
            collate=collate, batch_range=batch_range)
        return
    idx = shard_indices(len(dataset), shuffle=shuffle, seed=seed, epoch=epoch,
                        num_shards=num_shards, shard_id=shard_id, drop_last=drop_last)
    batches = [idx[i:i + batch_size] for i in range(0, len(idx), batch_size)]
    if drop_last:
        batches = [b for b in batches if len(b) == batch_size]
    if batch_range is not None:
        batches = batches[batch_range[0]:batch_range[1]]
    if not batches:
        return

    def fetch_item(i):
        # augmentation draws come from a stream of (seed, epoch, index)
        return fetch_with_ctx(dataset, epoch, int(i))

    if num_workers <= 0:
        for b in batches:
            yield collate([fetch_item(i) for i in b])
        return

    pool = ThreadPoolExecutor(max_workers=num_workers)
    q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
    stop = threading.Event()
    err: list = [None]  # the producer's exception, raised in the consumer

    def producer():
        try:
            for b in batches:
                if stop.is_set():
                    return
                q.put(collate(list(pool.map(fetch_item, b))))
        except BaseException as e:  # noqa: BLE001 re-raised by the consumer
            err[0] = e
        finally:
            q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                if err[0] is not None:
                    raise err[0]
                break
            yield item
    finally:
        stop.set()
        # drain until the producer exits: it may be blocked in q.put() with a
        # batch and then needs a free slot for its sentinel; a fetch stuck on
        # I/O is given up on after 30 s and its daemon thread left behind
        deadline = time.monotonic() + 30.0
        while t.is_alive() and time.monotonic() < deadline:
            try:
                q.get(timeout=0.1)
            except queue_mod.Empty:
                pass
            t.join(timeout=0.05)
        while True:
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break
        pool.shutdown(wait=False)


def _stage(x: np.ndarray) -> torch.Tensor:
    """A pinned host copy of ``x``, the source of an asynchronous upload."""
    return torch.from_numpy(np.ascontiguousarray(x)).pin_memory()


def device_prefetch(iterator, *, size: int = 2, device):
    """Keep ``size`` batches' arrays on ``device`` ahead of the consumer
    (``madtp_tpu/data/loader.py:190-215``), so a step never waits on its
    upload.  Each batch is a tuple: its numpy arrays become tensors on
    ``device``, its other columns pass through; order and contents are the
    input's.

    On a card each array is staged in pinned host memory and copied on a
    side stream with ``non_blocking=True``; when the batch is handed out,
    the consumer's current stream waits on that copy's event and each
    tensor is recorded as in use on it (``record_stream``), so the
    allocator does not reuse its memory while the consumer's work is
    queued.  On the CPU the batches are yielded as they come, their arrays
    as tensors."""
    dev = torch.device(device)
    if dev.type != "cuda":
        for batch in iterator:
            yield tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in batch)
        return
    side = torch.cuda.Stream(dev)

    def put(batch):
        hosts, out = [], []
        with torch.cuda.stream(side):
            for x in batch:
                if isinstance(x, np.ndarray):
                    hosts.append(_stage(x))
                    out.append(hosts[-1].to(dev, non_blocking=True))
                else:
                    out.append(x)
            done = torch.cuda.Event()
            done.record(side)
        return out, hosts, done

    def hand_out(item):
        out, _, done = item
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in out:
            if isinstance(t, torch.Tensor):
                t.record_stream(consumer)
        return tuple(out)

    buf = collections.deque()
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) > size:
            yield hand_out(buf.popleft())
    while buf:
        yield hand_out(buf.popleft())
