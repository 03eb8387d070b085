"""A small bounded LRU for captured-step caches (counterpart of
``madtp_tpu/utils/cache.py``).

The captured steps (:mod:`madtp_tpu_torch.utils.graph`) key CUDA graphs by
static arguments and input shapes.  Capacity schedules that move from epoch
to epoch could otherwise keep a graph, and its memory pool on the card, for
every schedule ever seen, so the caches are bounded: the least recently used
entry is dropped (which costs a capture again if that key recurs)."""

from __future__ import annotations

from collections import OrderedDict


class BoundedCache(OrderedDict):
    """OrderedDict with LRU eviction at ``maxsize`` entries."""

    def __init__(self, maxsize: int = 8):
        super().__init__()
        self.maxsize = maxsize

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.move_to_end(key)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self.move_to_end(key)
        while len(self) > self.maxsize:
            self.popitem(last=False)
