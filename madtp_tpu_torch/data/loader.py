"""Batched loader with sharding and threaded prefetch (counterpart of
``madtp_tpu/data/loader.py:20-189``): a ``DistributedSampler``-style index
schedule, worker threads that decode ahead of the card, and the same batch
order whatever the thread count."""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np

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
    that stops early unblocks and ends the producer thread."""
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
