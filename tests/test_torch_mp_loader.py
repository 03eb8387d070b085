"""The port's process-worker loader (``madtp_tpu_torch/data/mp_loader.py``)
and ``device_prefetch`` against the JAX package's loaders, after
``tests/test_data.py:221-300``: ``mp_batched_loader`` gives the threaded
loader's batches in its order (shuffled, sharded, mixed array and string
columns, shared-memory transport), the JAX process loader's too;
``batch_range`` keeps its slice of the schedule and fetches nothing outside
it; ``MADTP_MP_LOADER=1`` routes ``batched_loader`` through it; a worker's
failure reaches the consumer; no segment outlives the loader, also when the
consumer stops early; ``PerSampleRng`` transforms draw the threaded
loader's streams in the workers; ``device_prefetch`` keeps order and
contents on the CPU."""

import glob
import multiprocessing
import os

import numpy as np
import pytest
import torch

from madtp_tpu_torch.data.loader import batched_loader, device_prefetch
from madtp_tpu_torch.data.mp_loader import mp_batched_loader
from madtp_tpu_torch.data.transforms import PerSampleRng


class DS:
    """``n`` items: a 3x48x48 array (36 KB, so a batch of 4 goes through
    shared memory), a caption and an id."""

    def __init__(self, n=23):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((3, 48, 48), i, np.float32), f"cap {i}", i)


def _equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y)
            else:
                assert list(x) == list(y)


def _segments():
    return set(glob.glob("/dev/shm/madtp*"))


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=True, epoch=2),
                                dict(num_shards=2, shard_id=1, drop_last=True),
                                dict(shuffle=True, batch_range=(2, 4))],
                         ids=["plain", "shuffled", "sharded", "range"])
def test_mp_loader_matches_threaded_and_jax(kw):
    from madtp_tpu.data.mp_loader import mp_batched_loader as j_mp_batched_loader

    before = _segments()
    ds = DS()
    want = list(batched_loader(ds, 4, num_workers=2, **kw))
    got = list(mp_batched_loader(ds, 4, num_workers=2, **kw))
    _equal(want, got)
    _equal(list(j_mp_batched_loader(ds, 4, num_workers=2, **kw)), got)
    assert _segments() <= before


def test_batch_range_fetches_nothing_outside():
    """The workers write each index they fetch to a pipe; the range's
    batches are the full schedule's slice and nothing else is fetched."""
    read, write = multiprocessing.get_context("fork").Pipe(duplex=False)

    class Touched(DS):
        def __getitem__(self, i):
            write.send(int(i))
            return super().__getitem__(i)

    ds = Touched(22)
    full = list(batched_loader(ds, 4, num_workers=0))
    while read.poll():
        read.recv()
    got = list(mp_batched_loader(ds, 4, num_workers=2, batch_range=(2, 4)))
    _equal(full[2:4], got)
    touched = set()
    while read.poll(0.2):
        touched.add(read.recv())
    assert touched == set(range(8, 16))


def test_env_switch_routes_through_processes(monkeypatch):
    ds = DS(10)
    want = list(batched_loader(ds, 3, num_workers=2))
    calls = []
    import madtp_tpu_torch.data.mp_loader as M

    real = M.mp_batched_loader

    def spy(*a, **k):
        calls.append(k["num_workers"])
        return real(*a, **k)

    monkeypatch.setattr(M, "mp_batched_loader", spy)
    monkeypatch.setenv("MADTP_MP_LOADER", "1")
    _equal(want, list(batched_loader(ds, 3, num_workers=2)))
    assert calls == [min(2, os.cpu_count() or 1)]
    _equal(want, list(batched_loader(ds, 3, num_workers=0)))  # in line: no processes
    assert len(calls) == 1


def test_worker_failure_and_early_stop_leave_no_segment():
    class Bad(DS):
        def __getitem__(self, i):
            if i == 9:
                raise ValueError("bad item 9")
            return super().__getitem__(i)

    before = _segments()
    with pytest.raises(RuntimeError, match="bad item 9"):
        list(mp_batched_loader(Bad(), 4, num_workers=2))
    it = mp_batched_loader(DS(), 4, num_workers=2, prefetch=2)
    assert next(it)[2].tolist() == [0, 1, 2, 3]
    it.close()
    assert _segments() <= before


def test_per_sample_rng_streams_in_workers():
    """A ``PerSampleRng`` transform draws the stream of (seed, epoch, index)
    in a worker process as on a loader thread."""
    rng = PerSampleRng(7)

    class Aug(DS):
        def __getitem__(self, i):
            return (np.full((3, 48, 48), rng.random(), np.float32),
                    rng.randint(0, 1000), i)

    for epoch in (0, 3):
        want = list(batched_loader(Aug(12), 4, num_workers=3, shuffle=True, epoch=epoch))
        got = list(mp_batched_loader(Aug(12), 4, num_workers=3, shuffle=True, epoch=epoch))
        _equal(want, got)
    assert not np.array_equal(want[0][0], list(batched_loader(Aug(12), 4, shuffle=True))[0][0])


def test_device_prefetch_order_and_contents_on_cpu():
    from madtp_tpu.data.loader import device_prefetch as j_device_prefetch

    batches = [(np.full((2, 3), i, np.float32), [f"s{i}"], np.arange(i, i + 2))
               for i in range(5)]
    for size in (1, 2, 8):
        out = list(device_prefetch(iter(batches), size=size, device="cpu"))
        want = list(j_device_prefetch(iter(batches), size=size))
        assert len(out) == len(want) == 5
        for (a, s, ids), (ja, js, jids) in zip(out, want):
            assert isinstance(a, torch.Tensor) and isinstance(ids, torch.Tensor)
            assert np.array_equal(a.numpy(), np.asarray(ja)) and s == js
            assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert list(device_prefetch(iter([]), device="cpu")) == []
