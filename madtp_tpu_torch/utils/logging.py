"""Windowed metric meters and the iteration logger (counterpart of
``madtp_tpu/utils/logging.py``, reference ``utils.py:30-179``), single
process.  On the card the progress lines carry the peak memory that
``torch.cuda.max_memory_allocated`` reports."""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Optional

import torch


class SmoothedValue:
    """A series of values, smoothed over a window or averaged over all of it."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "\t", print_fn=print):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def global_avg(self):
        return self.delimiter.join(f"{name}: {meter.global_avg:.4f}"
                                   for name, meter in self.meters.items())

    def __str__(self):
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        """Iterate with a progress line every ``print_freq`` items: the ETA,
        the meters, the time per item and, on the card, the peak memory."""
        i = 0
        start_time = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        space = len(str(total)) if total else 6
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                mem = ""
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    mem = f" max mem: {torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MB"
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_str = str(datetime.timedelta(seconds=int(eta)))
                    self.print(f"{header} [{i:{space}d}/{total}] eta: {eta_str} {self} "
                               f"time: {iter_time} data: {data_time}{mem}")
                else:
                    self.print(f"{header} [{i}] {self} time: {iter_time}{mem}")
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        self.print(f"{header} Total time: {str(datetime.timedelta(seconds=int(total_time)))} "
                   f"({total_time / max(i, 1):.4f} s / it)")
