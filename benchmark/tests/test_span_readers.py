"""The readers of the program's spans and counters work their numbers out
from the records of ``madtp_tpu_torch.utils.profiling``, and read None
where there are none: a run without a trace, or a program without the
recorder."""

from __future__ import annotations

import types
from pathlib import Path

import pytest

from benchmark import harness
from benchmark.readings import vit_slots
from madtp_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]


def _span(rid, name, ms, parent=None, self_ms=None, item=None):
    return dict(kind="span", id=rid, name=name, item=item, parent=parent, start_ns=0,
                end_ns=int(ms * 1e6), self_ns=int((ms if self_ms is None else self_ms) * 1e6))


def _count(rid, name, value, parent=None):
    return dict(kind="count", id=rid, name=name, item=None, parent=parent, at_ns=0,
                value=value)


# two traced train steps: the step's feed holds _device_batch's, the
# dispatch its three phases, the forward the two counters
TRAIN = [
    _span(0, "feed", 30.0, item=1), _span(1, "feed", 28.0, parent=0),
    _span(2, "dispatch", 350.0, self_ms=10.0),
    _span(3, "forward", 120.0, parent=2, self_ms=120.0),
    _count(4, "kept.vision", [300] * 12, parent=3), _count(5, "kept.text", [9] * 12, 3),
    _span(6, "backward", 200.0, parent=2), _span(7, "optimizer", 20.0, parent=2),
    _span(8, "readback", 1.0, item=0),
    _span(9, "feed", 34.0, item=2), _span(10, "feed", 31.0, parent=9),
    _span(11, "dispatch", 330.0, self_ms=12.0),
    _span(12, "forward", 110.0, parent=11),
    _count(13, "kept.vision", [310] * 12, parent=12),
    _span(14, "backward", 190.0, parent=11), _span(15, "optimizer", 18.0, parent=11),
]
EVAL = [_span(0, "feed", 50.0), _span(1, "dispatch", 16.0), _span(2, "feed", 46.0),
        _span(3, "dispatch", 2.0), _span(4, "readback", 3.0, item=0)]
CLIP = [_span(0, "dispatch", 9.0), _span(1, "rank", 1200.0), _span(2, "rank", 1100.0)]


def _run(workload, caps=None):
    cell = harness.load_cell(ROOT, workload)
    return types.SimpleNamespace(cell=cell, stretch=object(),
                                 readings={"capacities": {"vision": caps, "text": None}})


CASES = [
    ("feed_ms.eval", "nlvr-eval-p50", EVAL, 48.0),
    ("dispatch_ms.eval", "nlvr-eval-p50", EVAL, 9.0),
    ("rank_ms.retrieval", "clip-eval-p50", CLIP, 1150.0),
    ("feed_ms.train", "nlvr-train-p50", TRAIN, 32.0),
    ("step_forward_ms.train", "nlvr-train-p50", TRAIN, 115.0),
    ("step_backward_ms.train", "nlvr-train-p50", TRAIN, 195.0),
    ("step_optimizer_ms.train", "nlvr-train-p50", TRAIN, 19.0),
]


@pytest.mark.parametrize("metric,workload,records,want", CASES)
def test_span_readers_average_the_outermost_spans(monkeypatch, metric, workload, records,
                                                  want):
    monkeypatch.setattr(profiling, "records", lambda: records)
    reader = harness.load_module("metrics", metric)
    assert reader.read(_run(workload)) == pytest.approx(want)


def test_capacity_fill_of_the_train_steps_reads_their_own_kept_counts(monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda: TRAIN)
    caps = [577, 400, 300] + [240] * 9
    run = _run("nlvr-train-p50", caps)
    slots = sum(vit_slots(run.cell.config, caps))
    # the steps' CLS and kept tokens, 301 and 311 at each of the 12 layers
    reader = harness.load_module("metrics", "capacity_fill.train")
    assert reader.read(run) == pytest.approx(100.0 * 12 * 306 / slots)


@pytest.mark.parametrize("metric,workload", [(m, w) for m, w, _, _ in CASES]
                         + [("capacity_fill.train", "nlvr-train-p50")])
def test_every_reader_reads_none_without_records_or_without_the_recorder(monkeypatch, metric,
                                                                         workload):
    reader = harness.load_module("metrics", metric)
    run = _run(workload, [577] * 12)
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert reader.read(run) is None
    for name in ("records", "span_ms"):
        monkeypatch.delattr(profiling, name)
    assert reader.read(run) is None
